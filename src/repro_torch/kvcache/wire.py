"""Wire format for cross-instance KV page transfer (disaggregation) —
PyTorch port of ``repro.kvcache.wire``.

The backend-uniform flat-payload swap format (the dict ``EngineCore``
produces at ``gather_park``/``export_request`` and consumes at
``exec_swap_in``) doubles as the wire format ``serving.disagg.KVTransfer``
moves between a prefill-tuned and a decode-tuned instance. This module
pins that contract down as data; both ends validate, so a drifting
payload fails at the seam instead of corrupting the peer's pool.

Payload schema (one dict per request)::

    rows         host tree of numpy arrays (or None); every leaf has the
                 page axis at 1 ([L, n_park, page, ...]). The fp K/V slabs
                 and, with the int8 cold tier, the quantized mirrors AND
                 their per-page scales ride in the same tree. bf16 rows
                 travel as their int16 bit pattern (numpy has no
                 bfloat16); an importer also takes a numpy bfloat16 leaf
                 (``ml_dtypes``) and reads its bits the same way
    park         [j] global logical indices of the gathered pages, in
                 rows' page-axis order
    kept         [(j, pid)] device-resident shared pages; a transfer
                 payload must have kept == [] (physical ids are
                 meaningless on the peer)
    n_pages      block-table length (park ∪ kept must cover it)
    lookup_toks  token tuple for the peer's prefix re-lookup (None when
                 prefix sharing is off)
    kind         "prefill" | "decode" + the matching progress fields
                 (swap_policy.progress_state / restore_progress)
    scores       optional [float] per-park-page DLZS scores (advisory)
    register_prefix  optional bool: the importer registers uploaded
                 full-prompt pages in its prefix index

The importer re-derives quant flags from the uploaded scale rows
(``quant.find_scale``) and recomputes DLZS scores from page content, so
``scores`` is advisory: conservation never depends on it.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.tree import tree_leaves

PREFILL_KEYS = ("prompt", "toks", "spans", "chunk", "sharing",
                "suppress_first")
DECODE_KEYS = ("length", "last_token", "budget")
_BASE_KEYS = ("rows", "park", "kept", "n_pages", "lookup_toks", "kind")


def payload_bytes(payload: dict) -> int:
    """Host bytes the payload's row tree carries (the hop's cost)."""
    rows = payload.get("rows")
    if rows is None:
        return 0
    return sum(int(leaf.nbytes) for leaf in tree_leaves(rows))


def validate_payload(payload: dict, *,
                     page_size: Optional[int] = None,
                     transfer: bool = False) -> None:
    """Raise ValueError when ``payload`` violates the wire contract.

    ``transfer=True`` also enforces the cross-instance rules: no ``kept``
    device references and a row tree wherever pages are parked."""
    missing = [k for k in _BASE_KEYS if k not in payload]
    if missing:
        raise ValueError(f"payload missing keys {missing}")
    kind = payload["kind"]
    if kind == "prefill":
        want = PREFILL_KEYS
    elif kind == "decode":
        want = DECODE_KEYS
    else:
        raise ValueError(f"payload kind {kind!r} not in "
                         "('prefill', 'decode')")
    missing = [k for k in want if k not in payload]
    if missing:
        raise ValueError(f"{kind} payload missing keys {missing}")

    park = list(payload["park"])
    kept = list(payload["kept"])
    n_pages = payload["n_pages"]
    covered = set(park) | {j for j, _ in kept}
    if covered != set(range(n_pages)):
        raise ValueError(
            f"park ∪ kept covers {sorted(covered)}, expected exactly "
            f"0..{n_pages - 1}")
    if len(covered) != len(park) + len(kept):
        raise ValueError("park and kept overlap")

    rows = payload["rows"]
    if park and rows is None:
        raise ValueError(f"{len(park)} parked pages but rows is None")
    if rows is not None:
        leaves = tree_leaves(rows)
        for leaf in leaves:
            if leaf.ndim < 2 or leaf.shape[1] != len(park):
                raise ValueError(
                    f"rows leaf {leaf.shape} page axis (1) != "
                    f"len(park)={len(park)}")
        if page_size is not None:
            # the K/V slab leaves carry page rows at axis 2; smaller
            # leaves (per-page scales) have fewer axes
            widths = {leaf.shape[2] for leaf in leaves if leaf.ndim >= 5}
            if widths and widths != {page_size}:
                raise ValueError(
                    f"rows page width {sorted(widths)} != page_size "
                    f"{page_size}")

    scores = payload.get("scores")
    if scores is not None and len(scores) != len(park):
        raise ValueError(
            f"scores carries {len(scores)} entries for "
            f"{len(park)} parked pages")

    if transfer and kept:
        raise ValueError(
            "transfer payload carries device page ids (kept="
            f"{kept}); physical ids do not travel between pools")


def describe(payload: dict) -> dict:
    """Compact summary for recorder/trace events (no array data)."""
    return {"kind": payload.get("kind"),
            "n_pages": payload.get("n_pages"),
            "parked": len(payload.get("park", ())),
            "kept": len(payload.get("kept", ())),
            "bytes": payload_bytes(payload),
            "scored": payload.get("scores") is not None}
