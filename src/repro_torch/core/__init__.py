"""ISC stacks, the Eq. 4 model, the device matcher and the fused SYNPA step."""
