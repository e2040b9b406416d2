"""Model families of the port: dense transformer, RG-LRU hybrid, Mamba-2."""
