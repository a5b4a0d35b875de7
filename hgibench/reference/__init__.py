"""The benchmark's plain reference: the HGI codec, the device coder's
format and the containers in NumPy.  It imports nothing of the program."""
