"""Model zoo, PyTorch port: the paper's three CNNs."""
