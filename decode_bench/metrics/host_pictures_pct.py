"""host_pictures_pct: the share of the window's pictures that the decoder's
fallback census sends to the host reconstruction (device_recon:*)."""


def read(run):
    w = run.window
    if not w.handed:
        return None
    host = sum(n for k, n in w.census.items()
               if k.startswith("device_recon:"))
    return 100.0 * host / len(w.handed)
