"""A frozen copy of the program's plain PyTorch SPEEDY model (T30L8 spectral
dynamics, column physics, daily coupler, boundary files) and its region
layout. Only relative imports: nothing here loads the program."""
