"""Step factories of the language-model scaffold: serving (prefill, decode)."""
