"""The plain reference of the benchmark and the comparison that decides
``correct``. Plain PyTorch; imports nothing of either package."""
