"""CPU tests of the benchmark; the `cuda` ones run on the card."""
