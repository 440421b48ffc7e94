"""Training: AdamW, int8 gradient compression with error feedback, the
seeded data pipeline and the train step (``repro.training`` of the JAX
package, on plain autograd; its ``grad_sync`` pod-axis collective is not
ported yet).

Parameter, gradient and optimizer-state trees are nested dicts of
tensors with the JAX package's keys (``tree``).
"""
