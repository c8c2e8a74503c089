"""Analytic cost model of a step: ``flops`` counts its operations and bytes
from the config, the input shape and the mesh; ``roofline`` turns them into
the least time an NVIDIA H100 could take."""
