"""PyTorch port: see the matching module of ``repro`` for the reference."""
