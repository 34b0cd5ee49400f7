"""The plain reference in numpy: it imports nothing of the program."""
