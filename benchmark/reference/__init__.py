"""The plain reference that decides a benchmark run's `correct`.

It imports neither jax nor anything of the measured program. `speedy/` is a
frozen copy of the program's plain PyTorch model code (dynamics, physics,
transforms, coupler, boundary files, region layout), kept here so that the
comparison stays put while the program changes; `hybrid.py` is a plain
single-member hybrid step on top of it, computed in float64.
"""
