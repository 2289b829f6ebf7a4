"""The plain reference: the ellipse's fields (:mod:`.fields`, NumPy) and a
Jacobi-preconditioned CG (:mod:`.pcg`, plain PyTorch). Imports nothing of
the program under test."""
