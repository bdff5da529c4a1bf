"""The plain reference of the benchmark: a tokenizer, the session graph
transform, the flagship ``GraphLevelEncoder`` forward and the searches,
in plain PyTorch and NumPy. It imports nothing of the program under test:
the tests hold it to the program on the CPU, and on the card it judges
what the program's timed path produced."""
