"""
The benchmark's plain reference of one simulation step, in NumPy and
plain PyTorch.

It imports nothing of the program under test.  It rebuilds from the
world's seed and the chemistry everything the program derives from them
(the codon maps, the token tables), translates genomes itself, assembles
the kinetic parameters, integrates with the reversible Michaelis-Menten
integrator and applies selection and map physics.  The algorithms follow
upstream magic-soup 1.0.5 (``genetics.py``, ``kinetics.py``,
``world.py``) as the port implements them; this is a frozen copy kept
with the benchmark, so a change to the program cannot move it.
"""
