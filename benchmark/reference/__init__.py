"""The plain float32 reference that decides a run's `correct`. It imports
neither JAX nor the JAX package nor anything of the program."""
