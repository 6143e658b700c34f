"""Set-up: from the start of the process (before torch is imported) to the
end of the warm-up cases: imports, the CUDA context, the kernels' builds on
a checkout's first run, the pool of cases and the warm-up."""


def read(ctx):
    return ctx.setup_s
