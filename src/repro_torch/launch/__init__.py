"""Entry points of the LM family: the serving steps (`serve`)."""
