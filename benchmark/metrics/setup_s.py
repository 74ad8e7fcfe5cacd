"""setup_s: seconds from the process's start to the window's first frame
(host clock): the build check, the pipeline's construction, the frames
drawn from the seed and the warm-up frames."""


def read(ctx):
    return ctx.setup_s
