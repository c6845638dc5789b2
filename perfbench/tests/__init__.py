"""CPU tests of the benchmark (the ones marked ``cuda`` need a card)."""
