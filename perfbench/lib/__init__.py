"""The benchmark's yardstick and drivers (see ``perfbench/README.md``)."""
