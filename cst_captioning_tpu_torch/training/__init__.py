"""Training of the port: one XE, WXE or CST stage (``trainer.py``), its
steps, optimizer, host-side rewards, validation and checkpoints."""
