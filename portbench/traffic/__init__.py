"""The benchmark's traffic: frozen copies of the port's generators, and
the general driver that reads a cell's traffic parameters."""
