"""Training: AdamW, int8 gradient compression with error feedback, the
seeded data pipeline, the train step (``repro.training`` of the JAX
package, on plain autograd) and ``grad_sync``, the int8 gradient
average across pods as a ``torch.distributed`` collective.

Parameter, gradient and optimizer-state trees are nested dicts of
tensors with the JAX package's keys (``tree``).
"""
