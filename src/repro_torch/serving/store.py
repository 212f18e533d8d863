"""Full-precision embedding store: global news id -> row, on the device.

User encoding, the stage-2 re-rank and full rebuilds all read the store
where the JAX package kept a host array beside a device mirror; here the
device tensor is the store. A publish writes its deduped rows in place
(``index_copy_``, where the JAX package rebinds a fresh array), so
publishing a handful of ids never re-uploads the whole [N, d] matrix.

Row 0 is the pad news and stays zero. Rows only ever grow (growth
rebinds a fresh tensor, so older references stay valid) or get
overwritten in place with fresher embeddings. The overwrite is not atomic
per row: a query gathering candidates exactly while one of its ids is
re-published can read that row half-updated. The window is bounded to
freshly re-published ids and perturbs one re-rank score for one query.
"""
from __future__ import annotations

import numpy as np
import torch


class EmbeddingStore:
    """[N, d] float32 store keyed by global id, growable."""

    def __init__(self, emb, *, grow_chunk: int = 1, device="cuda"):
        """``emb``: numpy or a tensor (copied). ``grow_chunk``: capacity
        growth granularity, in rows (capacity rows stay zero until
        published)."""
        self.device = torch.device(device)
        self._emb = torch.as_tensor(emb, dtype=torch.float32).to(
            self.device, copy=True)
        self.grow_chunk = max(1, int(grow_chunk))

    def __len__(self) -> int:
        return self._emb.shape[0]

    @property
    def dim(self) -> int:
        return self._emb.shape[1]

    @property
    def emb(self) -> torch.Tensor:
        """The [N, d] store on its device."""
        return self._emb

    def scatter(self, ids, rows):
        """Grow to cover max(ids)+1, then last-write-wins the fresh rows
        (numpy or a tensor) into the store. Returns the deduped ``(ids,
        rows)`` actually written, as numpy (duplicate ids within one batch
        resolve to the last occurrence)."""
        ids = np.asarray(ids, np.int64)
        rows = torch.as_tensor(rows, dtype=torch.float32, device=self.device)
        if ids.size == 0:
            return ids, rows.cpu().numpy()
        if ids.min() < 0 or ids.max() >= 2 ** 31:
            raise ValueError("publish ids must be in [0, 2**31)")
        need = int(ids.max()) + 1
        if need > len(self):
            need = -(-need // self.grow_chunk) * self.grow_chunk
            self._emb = torch.cat(
                [self._emb, torch.zeros((need - len(self), self.dim),
                                        device=self.device)])
        uniq, first_rev = np.unique(ids[::-1], return_index=True)
        rows = rows[torch.as_tensor(ids.size - 1 - first_rev,
                                    device=self.device)]
        # in place: only the fresh rows are written
        self._emb.index_copy_(0, torch.as_tensor(uniq, device=self.device),
                              rows)
        return uniq, rows.cpu().numpy()
