"""Command line: the ``deploy`` verb."""
