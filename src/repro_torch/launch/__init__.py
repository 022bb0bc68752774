"""Entry points of the port's LM stack (serve.py: decode serving from the command line)."""
