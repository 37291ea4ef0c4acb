"""The plain reference that decides `correct`: plain PyTorch, importing
nothing of the program or of the JAX package (`model`), and the numbers
compared between the two (`compare`)."""
