"""The benchmark's plain reference: what each cell's jobs must produce,
worked out again from the cell's inputs with NumPy and plain PyTorch
operations (on the card when one is given, in blocks of rows).

It imports nothing of JAX, of the JAX package or of the port, and takes
nothing the port made: the hash factors, the modimizers, the tables, the
lookups and the chaining are all derived here from the seed's inputs and
the configuration's parameters.
"""
