#!/usr/bin/env python
"""Merge per-subdomain output files into global arrays.

Counterpart of the reference's utils/merge_subdomains.py. This build
writes one file per run (the mesh is transparent), so merging is usually a
rename; this tool still reassembles multi-file outputs produced by
location-annotated runs for compatibility with reference post-processing
scripts.
"""

import argparse
import glob
import re

import numpy as np

from sailfish_tpu import io as sio


def merge_subdomains(base, digits, it, save=True):
    """Returns dict of merged arrays for iteration ``it``; with a single
    subdomain this is just that file's contents."""
    pattern = f'{base}.*.{it:0{digits}d}.npz'
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(pattern)
    if len(files) == 1:
        data = dict(np.load(files[0]))
    else:
        # multiple subdomains: stack along the outermost axis by id order
        def sub_id(fname):
            m = re.search(r'\.(\d+)\.\d+\.npz$', fname)
            return int(m.group(1)) if m else 0
        files.sort(key=sub_id)
        parts = [dict(np.load(f)) for f in files]
        data = {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}
    # repackage vector components as 'v' for reference-script compatibility
    if 'vx' in data and 'v' not in data:
        comps = [data['vx'], data['vy']]
        if 'vz' in data:
            comps.append(data['vz'])
        data['v'] = np.stack(comps)
    if save:
        out = sio.merged_filename(base, digits, it)
        np.savez(out, **data)
        return out
    return data


def main():
    p = argparse.ArgumentParser()
    p.add_argument('base')
    p.add_argument('iteration', type=int)
    p.add_argument('--digits', type=int, default=7)
    args = p.parse_args()
    out = merge_subdomains(args.base, args.digits, args.iteration)
    print('wrote', out)


if __name__ == '__main__':
    main()
