"""Page arithmetic for the paged KV cache.

Copied from ``repro/serve/kv_pool.py`` (the port never imports the JAX
package).  The host-side allocator ``KVPool`` and its prefix trie wait for
the scheduler slice; ``Engine.generate`` plans its call-sized pool itself.
"""

from __future__ import annotations

__all__ = ["pages_for", "table_width_for"]


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` tokens: ceil(tokens / page_size)."""
    return -(-tokens // page_size)


def table_width_for(max_seq: int, page_size: int, headroom: int = 0) -> int:
    """Logical pages per slot: ceil((max_seq + headroom) / page_size).

    ``headroom`` covers decode-segment overshoot (power-of-two quantized
    segments may write up to a segment past a request's budget)."""
    return pages_for(max_seq + headroom, page_size)
