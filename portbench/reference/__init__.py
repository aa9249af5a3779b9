"""The plain reference of the benchmark's configurations: plain PyTorch
(and NumPy) training steps written from the layer equations, with their own
adjacency, padding-free batches and Adam.  Nothing here imports the program
under test; the weights and inputs come from the benchmark's generators."""
