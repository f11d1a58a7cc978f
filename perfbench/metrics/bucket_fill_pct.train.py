"""The window's largest count of visible anchors over the decode's bucket
(``visible_capacity``), in percent: above 100, visible anchors were left
out of a step's decode (``models/render.py::compact_visible``). None
without a bucket."""


def read(ctx):
    gs = {**ctx["config"]["gsconfig"], **ctx["traffic"].get("gsconfig", {})}
    records = ctx.get("records") or ()
    if not gs.get("visible_capacity") or not records:
        return None
    return 100.0 * max(r["n_visible_anchors"] for r in records) \
        / gs["visible_capacity"]
