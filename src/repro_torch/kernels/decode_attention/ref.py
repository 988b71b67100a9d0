"""Plain PyTorch version of the ``decode_attention`` kernel (CPU tensors
take it): each row's pages gathered into a view of the dense slab's
shape, then ``layers.attention_decode``."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def decode_attention_ref(q: torch.Tensor, k_arena: torch.Tensor,
                         v_arena: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, max_len: int) -> torch.Tensor:
    """One decode step's attention; q ``[B, N, H]``, arenas ``[n_pages,
    page_tokens, KV, H]`` (row b's position t at page ``page_table[b, t //
    page_tokens]``), lengths ``[B]`` (the positions the step writes),
    the step's k_new, v_new ``[B, KV, H]`` -> ``[B, N, H]`` in q's type.

    Each side's pages are gathered in order into a contiguous ``[B,
    max_len, KV, H]`` view, the step's row is written into the view at
    ``lengths`` (nothing where ``lengths == max_len``), and
    ``layers.attention_decode`` attends over ``lengths + 1`` positions:
    the shape a dense slab presents, so a dense slab passed as an arena
    of one ``max_len`` page a row gives the bits of the slab itself.  The
    new row is then scattered to its page (a row at ``max_len`` writes
    its own last position back unchanged)."""
    b, n_pp = page_table.shape
    _, p, n_kv, h = k_arena.shape
    table = page_table.long()
    lengths = lengths.long()
    rows = torch.arange(b, device=q.device)
    at = lengths.clamp(0, max_len - 1)
    live = (lengths < max_len)[:, None, None]
    dest, off = table[rows, at // p], at % p

    def view(arena, new):
        full = arena[table].reshape(b, n_pp * p, n_kv, h)[:, :max_len]
        full = full.contiguous()
        full[rows, at] = torch.where(live, new.to(arena.dtype),
                                     full[rows, at])
        arena[dest, off] = full[rows, at]
        return full

    out = L.attention_decode(q[:, None], view(k_arena, k_new),
                             view(v_arena, v_new), lengths + 1)
    return out[:, 0]
