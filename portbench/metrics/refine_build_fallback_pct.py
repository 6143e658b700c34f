"""Centerline refine build: the share of builds that took the per-frame
path, 100 x calls of span ``centerline.refine_build_fallback`` / calls of
span ``centerline.refine_build``.  0.0 where every grid was built on the
device (a program without the device build opens no fallback span either);
nothing to read where no refine grid was built."""


def read(ctx):
    build = ctx.spans.get("centerline.refine_build")
    if build is None or not build[1]:
        return None
    fallback = ctx.spans.get("centerline.refine_build_fallback")
    return 0.0 if fallback is None else 100.0 * fallback[1] / build[1]
