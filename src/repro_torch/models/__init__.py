"""Model zoo, PyTorch port: the paper's three CNNs (``cnn``) and the
dense-attention transformers (``config``, ``layers``, ``transformer``)."""
