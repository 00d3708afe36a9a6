"""Examples of the PyTorch port, each runnable with ``python -m`` (ports of
the JAX repo's ``examples/``): :mod:`.helloworld`, :mod:`.segmented` and
:mod:`.soak`."""
