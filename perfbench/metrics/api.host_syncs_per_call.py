"""Host syncs a call inside the matcher's entries (`match_raw` and
`sample_batched`, or `match` and `sample`), as sync debug mode "warn"
reports them; the benchmark's own upload and readback are left out."""


def read(r):
    return r.syncs_per_call
