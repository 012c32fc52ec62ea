"""Frozen measuring rods: the card's published peaks and the bytes that
kernels and whole Krylov iterations must move, computed from shapes alone,
independently of how the program fuses or lays out its data."""
