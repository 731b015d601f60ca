"""The benchmark's plain reference: the CCVPE model, its losses and Adam in
float32 PyTorch. Imports nothing of the program under test."""
