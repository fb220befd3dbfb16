"""How the port is built for each family of networks."""
