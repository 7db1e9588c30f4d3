"""What the serving stack keeps of the chiplet simulator (port of the
jax-free part of ``repro.sim``): the Table-I hardware constants the
modeled clock reads and the request splitter the traffic generator draws
from.  The simulator itself is not ported."""
