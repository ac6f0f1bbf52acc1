"""The encoder's per-frame device programs on SB-row stripes of a frame
(the port of ``__graft_entry__.py``'s ``dryrun_multichip``): ``stripes``
holds the stripe step and its two neighbour exchanges (one process on one
device, or one stripe per ``torch.distributed`` rank); ``dryrun`` runs
it on a coded frame's state and holds it against the whole frame's run.
"""
