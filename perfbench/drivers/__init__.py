"""The general generators of the traffic mixes: a mix's ``driver`` key names
one module here, whose ``run(cell, seed, seconds, trace, device, t_start)``
sets up, warms up, drives the window and checks what the window produced,
all from the cell's configuration and the mix's parameters."""
