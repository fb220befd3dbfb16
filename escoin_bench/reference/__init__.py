"""Plain references, one module a family of networks; none imports the
program."""
