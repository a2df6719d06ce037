"""Plain PyTorch references, one a configuration; none imports the port."""
