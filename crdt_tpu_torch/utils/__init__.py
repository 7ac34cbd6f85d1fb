"""Small shared helpers (the retry-timing jitter)."""
