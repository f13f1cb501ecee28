"""The plain reference that decides whether a run's answers are correct:
RAFFT's fold in Python, NumPy and SciPy (fold.py) over the exact integer
Turner-2004 energy (energy.py, turner2004.py, calibrated.py).  It imports
nothing of the program and nothing of JAX.

Its energy parameters are not independent of the program: turner2004.py
and calibrated.py are frozen copies of the port's tables, whose
corrections were fitted to upstream RAFFT's published (sequence,
structure, energy) rows by the repository's calibration tool.  So the
comparison holds the engine's search and its device arithmetic to a
sequential fold over the same parameters; an error in a parameter value
is shared by both sides and passes."""
