"""Training: optimizer and train / eval steps."""
