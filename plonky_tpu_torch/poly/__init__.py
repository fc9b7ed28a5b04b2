"""Polynomials: FFTs (fft.py) and coefficient-form helpers (polynomial.py)."""
