"""Model configurations (the forward pass waits for the model slice)."""
