"""Plain float32 PyTorch references of the benchmark's configurations.
They import nothing of the program under test and take nothing it made."""
