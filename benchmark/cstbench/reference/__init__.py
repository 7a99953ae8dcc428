"""The plain reference: float32 PyTorch and Python that import nothing of
the program and take nothing it made but the outputs they judge."""
