"""The benchmark's plain reference: prime fields and short Weierstrass
curves on Python ints, NumPy and plain PyTorch, written from the published
constants in the configuration files.  It imports nothing of the program
under test and reads the program's outputs only to judge them."""
