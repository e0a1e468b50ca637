"""Device ops: factor tables (``als``) and scoring + top-k (``topk``)."""
