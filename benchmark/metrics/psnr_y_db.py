"""psnr_y_db: the mean luma PSNR, against their sources, of the pictures
the reference decoded from each channel's packets (the decode sample,
equal to the reconstructions), over the channels."""


def read(run):
    got = [r["psnr_y_db"] for r in run["results"]]
    if any(x is None for x in got):
        return None
    return sum(got) / len(got)
