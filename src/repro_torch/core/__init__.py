"""ESD core, host side (numpy): Alg. 1's serving cost column and Alg. 2."""
