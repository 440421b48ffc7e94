"""DistAttention math: online-softmax partials, their merge (in this
process or across a process group), attention over a whole KV or a
partition of it, paged helpers."""
from repro_torch.core.online_softmax import (
    combine, empty_partial, finalize, merge_partials,
    merge_partials_collective, micro_attention_decode,
    micro_attention_prefill,
)
from repro_torch.core.attention import (
    dist_attention_decode, dist_attention_prefill,
    full_attention_decode, full_attention_prefill,
)
from repro_torch.core.distattn import (
    distattn_decode_paged, gather_local_kv, local_mask_from_table,
    merge_over_axes,
)

__all__ = [
    "combine", "empty_partial", "finalize", "merge_partials",
    "merge_partials_collective", "micro_attention_decode",
    "micro_attention_prefill", "dist_attention_decode",
    "dist_attention_prefill", "full_attention_decode",
    "full_attention_prefill", "distattn_decode_paged", "gather_local_kv",
    "local_mask_from_table", "merge_over_axes",
]
