"""D-Rank core: capture (calibration Grams) -> numerics (whitened SVD,
effective rank) -> groups (cross-layer grouping policies) -> allocate
(Lagrange closed form, beta rebalance, integerization) -> compress (pipeline
and baselines)."""
