"""Loss heads (forward parts used by zero-shot scoring)."""
