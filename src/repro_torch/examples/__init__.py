"""The port's walkthroughs, the counterparts of the JAX package's
``examples/*.py``, run as ``python -m repro_torch.examples.<name>
[--device cpu]``: ``quickstart``, ``mr_algorithms``, ``serve_queries``,
``serve_batch``, ``obs_demo`` and ``train_lm``.  Each runs on the card
unless given ``--device cpu``, and prints the JAX example's labels.

Each example's sections are functions that take their inputs and random
draws and return the numbers they print, so that a test can feed them the
JAX package's draw."""
