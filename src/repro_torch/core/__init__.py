"""ISC stacks, the Eq. 4 model, the matchers (host tiers and device tier),
the fused SYNPA step, the SYNPA scheduler and the paper's baselines."""
