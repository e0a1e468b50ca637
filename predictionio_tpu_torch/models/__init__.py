"""Engine templates and the model file format."""
