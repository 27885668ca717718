"""Scan-tier solvers: padded-rank ALS and the Crank–Nicolson step."""
