"""moe.padded_row_share: the share of the expert-product rows that the
window's MoE dispatch computed for no assignment, 1 - assigned / rows
over the window's engine steps (the columns ``moe_assigned`` and
``moe_rows`` of the program's step clock, ``repro_torch.tracing``), in
%.  The padding a dropless dispatch pays.  Nothing where the program's
clock has no such columns, none of its steps lies in the window, or the
steps computed no expert row."""


def read(run):
    if run["kind"] != "serve":
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    st = tracing.steps()
    if "moe_rows" not in st or "moe_assigned" not in st:
        return None
    inside = ((st["start_ns"] >= run["t0"] * 1e9)
              & (st["end_ns"] <= run["t1"] * 1e9))
    rows = int(st["moe_rows"][inside].sum())
    if not rows:
        return None
    return 100.0 * (1.0 - int(st["moe_assigned"][inside].sum()) / rows)
