"""Process utilities of the port (the progress watchdog)."""
