"""Block-Max WAND pivot selection kernel family."""
