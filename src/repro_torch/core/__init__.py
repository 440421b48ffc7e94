"""DistAttention math: online-softmax partials, their merge, paged helpers."""
from repro_torch.core.online_softmax import (
    combine, empty_partial, finalize, merge_partials,
    micro_attention_decode, micro_attention_prefill,
)
from repro_torch.core.distattn import (
    distattn_decode_paged, gather_local_kv, local_mask_from_table,
)

__all__ = [
    "combine", "empty_partial", "finalize", "merge_partials",
    "micro_attention_decode", "micro_attention_prefill",
    "distattn_decode_paged", "gather_local_kv", "local_mask_from_table",
]
