"""Postprocess: the share of pairs that took the object path, 100 x calls of
span ``postprocess.object_path`` / calls of span ``postprocess.pair``.  0.0
where every pair ran on its frame stacks (a program without the stack path
opens no ``postprocess.object_path`` either); nothing to read where no pair
was postprocessed."""


def read(ctx):
    pair = ctx.spans.get("postprocess.pair")
    if pair is None or not pair[1]:
        return None
    fallback = ctx.spans.get("postprocess.object_path")
    return 0.0 if fallback is None else 100.0 * fallback[1] / pair[1]
