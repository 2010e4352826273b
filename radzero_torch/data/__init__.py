"""Host-side data helpers the port needs without importing radzero_tpu."""
