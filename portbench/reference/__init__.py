"""The yardstick, frozen with the benchmark; imports nothing of the
program."""
