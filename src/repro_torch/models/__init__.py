"""The language-model scaffold's serving path: layers, attention, the dense backbone."""
