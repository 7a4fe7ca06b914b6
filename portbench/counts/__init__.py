"""The benchmark's frozen yardstick: the chip's peaks and the operations and
bytes that one call of each kernel, and one token of each model, needs."""
