"""The plain reference of the flame flows: float64 PyTorch, no kernel of
the program, no import of it.  ``precision`` switches every function to
the control's arithmetic (float32 with TF32 matrix products)."""
