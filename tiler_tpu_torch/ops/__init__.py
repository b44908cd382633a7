"""The port's array kernels and their plain torch versions."""
