"""Host models and their device encodings."""
