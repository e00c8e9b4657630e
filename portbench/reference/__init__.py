"""The plain references of the configurations: plain torch and numpy,
nothing of the program."""
