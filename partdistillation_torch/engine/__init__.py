"""Training engine: optimizer and trainer."""
