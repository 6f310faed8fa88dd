"""job_start_s: host seconds from the learning job's call to its first
training pass, the card synchronised: the copy of the images to the card,
the draws, the clean-label pass and the first epoch's gather. A job pays
it once; it falls in set-up, before the window's epochs."""


def read(ctx):
    return ctx.host_s.get("job_start")
