"""A/B stream-verification harness for codec kernel changes (port of
imgcomp_cvpr_tpu/tools/ab_streams.py).

Every kernel change MUST prove byte-identical streams + decoded volumes
against the committed kernels before landing. The tool has four modes:

  dump     encode + decode a fixed deterministic workload and pickle
           {streams, volumes, parsed payloads, kernel libraries} to a file.
  compare  byte-compare two dump files (streams AND volumes), or with
           --payload-only the parsed words / states / CRC.
  cross    decode the STREAMS of a dump file through the CURRENT tree's
           codec and check the volumes match (catches changes that move
           both encoder and decoder the same wrong way).
  ab       orchestrate all of it against a pristine-HEAD git worktree:
           dump there and here (one process each, each tree's own package),
           compare, cross-decode HEAD's streams.

Typical gate before committing a kernel change (on the card; --cpu runs
the plain versions, which no kernel change moves):

  python -m imgcomp_cvpr_tpu_torch.tools.ab_streams ab --impl cuda
  python -m imgcomp_cvpr_tpu_torch.tools.ab_streams ab --impl cuda_planar --k 5

Workload: random-init pc params (``probclass.init_params``, seed + 1) +
uniform random symbols (``np.random.RandomState(seed)``) at a Kodak-ratio
latent shape, batch 8, centers linspace(-2, 2, L). ``--impl`` is one of the
port's codecs: ``cuda`` (K=3 wavefront, kernels 2 and 3) or ``cuda_planar``
(planar, kernels 5 and 6). The ``cuda`` codec encodes at the precision
that $IMGCOMP_PALLAS_PREC names (f32 when unset), as the JAX tool's does;
a dump records it. The port codes at bsub 1 only, so ``--bsubs`` is [1];
any other value raises. A dump prints the sha256 digest of its streams
(``digest``), the number that a byte gate can pin.

Each tree runs its own kernels: ops/kernels/build.py keys the libraries to
the checkout (build/torch_kernels/ beside the package) and to the hash of
its sources, so a HEAD worktree builds HEAD's csrc/. A dump records the
library file names (source hashes) of its tree and the ones it loaded.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile

_PORTED_BSUBS = (1,)


def _build(shape, L, k, seed, device):
    import numpy as np
    from ..coding import codec as codec_lib
    from ..models import probclass as pc_lib
    from ..utils import config as config_lib

    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    pc_config = pc_config.replace(kernel_size=k)
    pc = pc_lib.init_params(pc_lib.ProbClassifier(pc_config, L, device=device), seed + 1)
    rng = np.random.RandomState(seed)
    centers = np.linspace(-2.0, 2.0, L).astype(np.float32)
    return pc, pc_config, centers, rng, codec_lib


def _device(args) -> str:
    return 'cpu' if args.cpu else 'cuda'


def _check_bsubs(bsubs) -> None:
    bad = sorted(set(bsubs) - set(_PORTED_BSUBS))
    if bad:
        raise ValueError(
            f'--bsubs {bad}: the port codes at bsub 1 only. bsub > 1 packs several '
            'images into one Pallas instance to fit the TPU\'s VMEM, and the JAX '
            'package holds its streams bitwise invariant across bsub; the port\'s '
            'kernels keep no such ring, and their contract is batch-size invariance')


def digest(streams) -> str:
    """sha256 of a batch's streams, each prefixed by its length."""
    h = hashlib.sha256()
    for s in streams:
        h.update(len(s).to_bytes(8, 'little'))
        h.update(s)
    return h.hexdigest()


def _kernel_libs():
    """(this tree's library file name of every kernel source, the libraries
    this process loaded)."""
    from ..ops.kernels import build
    tree = {name: os.path.basename(build._lib_path(name)) for name in build.SOURCES}
    loaded = {name: os.path.basename(lib._name) for name, lib in build._libs.items()}
    return tree, loaded


def cmd_dump(args):
    import numpy as np
    _check_bsubs(args.bsubs)
    shape = tuple(args.shape)
    pc, cfg, centers, rng, codec_lib = _build(shape, args.L, args.k, args.seed,
                                              _device(args))
    syms = rng.randint(0, args.L, size=(args.batch,) + shape).astype(np.int8)
    out = {'shape': shape, 'L': args.L, 'k': args.k, 'seed': args.seed,
           'batch': args.batch, 'impl': args.impl, 'cases': {}}
    if args.impl == 'cuda':
        from ..coding import cuda_codec
        out['prec'] = cuda_codec.encode_prec()
    for bsub in args.bsubs:
        codec = codec_lib.LatentCodec(pc, cfg, device=_device(args), impl=args.impl)
        coder = codec.coder(codec.impl_id)
        res = coder.encode_batch(syms, centers)
        dec = codec.decode_batch([r.bitstream for r in res], centers, device_out=False)
        np.testing.assert_array_equal(dec, syms.astype(np.int32))
        # Parsed payloads (words/states/crc via THIS tree's deserializer):
        # the container-version-agnostic identity surface — compare these
        # across trees when a container format change legitimately moves
        # the raw bytes (e.g. a version bump).
        payloads = []
        for r in res:
            parsed = codec_lib.deserialize_stream(r.bitstream)
            words, states, crc = parsed[1], parsed[2], parsed[3]
            payloads.append({'words': np.asarray(words, np.uint32),
                             'states': np.asarray(states, np.uint32),
                             'crc': int(crc)})
        out['cases'][bsub] = {
            'streams': [r.bitstream for r in res],
            'volumes': np.asarray(dec),
            'payload': payloads,
            'digest': digest([r.bitstream for r in res]),
        }
        print(f'  dump: impl={args.impl} bsub={bsub} ok '
              f'({sum(len(r.bitstream) for r in res)} stream bytes, digest '
              f'{out["cases"][bsub]["digest"]})')
    out['kernel_libs'], out['kernel_libs_loaded'] = _kernel_libs()
    with open(args.out, 'wb') as f:
        pickle.dump(out, f)
    print(f'  dump: wrote {args.out} (bsubs {sorted(out["cases"])}; kernels '
          f'{sorted(out["kernel_libs_loaded"].values()) or "none loaded (plain versions)"})')


def _load(path):
    # Dumps are this tool's own files (unpickling runs code: trusted input only).
    with open(path, 'rb') as f:
        return pickle.load(f)


def cmd_compare(args):
    import numpy as np
    a, b = _load(args.a), _load(args.b)
    for key in ('shape', 'L', 'k', 'seed', 'batch', 'impl'):
        if a[key] != b[key]:
            print(f'compare: the dumps differ in {key}: {a[key]} vs {b[key]}')
            return 1
    common = sorted(set(a['cases']) & set(b['cases']))
    if not common:
        print('compare: no common bsub cases')
        return 1
    payload_only = getattr(args, 'payload_only', False)
    n_bad = 0
    for bsub in common:
        ca, cb = a['cases'][bsub], b['cases'][bsub]
        if payload_only:
            # Container-version-agnostic: words + states + CRC as parsed
            # by EACH tree's own deserializer at dump time. The gate for
            # kernel changes that land together with a format bump.
            for i, (pa, pb) in enumerate(zip(ca['payload'], cb['payload'])):
                for f in ('words', 'states'):
                    if not np.array_equal(pa[f], pb[f]):
                        print(f'PAYLOAD {f.upper()} MISMATCH bsub={bsub} '
                              f'image={i}')
                        n_bad += 1
                if pa['crc'] != pb['crc']:
                    print(f'PAYLOAD CRC MISMATCH bsub={bsub} image={i}')
                    n_bad += 1
        else:
            for i, (sa, sb) in enumerate(zip(ca['streams'], cb['streams'])):
                if sa != sb:
                    print(f'STREAM MISMATCH bsub={bsub} image={i}: '
                          f'{len(sa)} vs {len(sb)} bytes')
                    n_bad += 1
        if not np.array_equal(ca['volumes'], cb['volumes']):
            print(f'VOLUME MISMATCH bsub={bsub}')
            n_bad += 1
    if a.get('kernel_libs') != b.get('kernel_libs'):
        print(f'compare: kernel sources differ: {a.get("kernel_libs")} vs '
              f'{b.get("kernel_libs")}')
    if n_bad:
        print(f'compare: {n_bad} mismatches between {args.a} and {args.b}')
        return 1
    what = 'payloads (words/states/crc)' if payload_only else 'streams'
    print(f'compare: {what} byte-identical across bsubs {common}')
    return 0


def cmd_cross(args):
    """Decode the dump's streams with the CURRENT tree; volumes must match."""
    import numpy as np
    d = _load(args.a)
    pc, cfg, centers, _, codec_lib = _build(tuple(d['shape']), d['L'], d['k'],
                                            d['seed'], _device(args))
    bsub = sorted(d['cases'])[0]
    case = d['cases'][bsub]
    codec = codec_lib.LatentCodec(pc, cfg, device=_device(args))
    dec = codec.decode_batch(case['streams'], centers, device_out=False)
    np.testing.assert_array_equal(dec, case['volumes'])
    print(f'cross: decoded {len(case["streams"])} streams from {args.a} '
          'byte-identically with the current tree')
    return 0


def cmd_ab(args):
    """Dump in a pristine-HEAD worktree AND here; compare; cross-decode."""
    _check_bsubs(args.bsubs)
    repo = subprocess.check_output(
        ['git', 'rev-parse', '--show-toplevel'], text=True).strip()
    head = subprocess.check_output(
        ['git', 'rev-parse', 'HEAD'], text=True, cwd=repo).strip()
    wt = args.worktree or os.path.join(tempfile.gettempdir(),
                                       f'ab_head_{head[:12]}')
    if not os.path.isdir(wt):
        subprocess.check_call(['git', 'worktree', 'add', '--detach', wt,
                               head], cwd=repo)
        print(f'ab: created HEAD worktree {wt} @ {head[:12]}')
    # The HARNESS is not the code under test: run THIS tool version in the
    # worktree too, so new dump fields exist on both sides even when HEAD
    # predates them.
    rel_tool = os.path.join('imgcomp_cvpr_tpu_torch', 'tools', 'ab_streams.py')
    os.makedirs(os.path.dirname(os.path.join(wt, rel_tool)), exist_ok=True)
    shutil.copy(os.path.abspath(__file__), os.path.join(wt, rel_tool))
    dumps = tempfile.mkdtemp(prefix='ab_streams_')
    dump_a = os.path.join(dumps, 'head.pkl')
    dump_b = os.path.join(dumps, 'work.pkl')
    tool = [sys.executable, '-m', 'imgcomp_cvpr_tpu_torch.tools.ab_streams'] + (
        ['--cpu'] if args.cpu else [])
    base = tool + ['dump', '--shape'] + [str(s) for s in args.shape] + [
        '--L', str(args.L), '--k', str(args.k), '--seed', str(args.seed),
        '--batch', str(args.batch), '--impl', args.impl,
        '--bsubs'] + [str(b) for b in args.bsubs]

    def env(root):
        # each tree imports its own package (and so builds its own kernels)
        return dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]))

    print('ab: dumping streams from pristine HEAD...')
    try:
        subprocess.check_call(base + ['--out', dump_a], cwd=wt, env=env(wt))
    finally:
        # leave the (reused) worktree pristine; the copy is re-made per run
        if subprocess.call(['git', 'checkout', '--', rel_tool], cwd=wt,
                           stderr=subprocess.DEVNULL):
            os.remove(os.path.join(wt, rel_tool))      # HEAD has no such tool
    print('ab: dumping streams from the working tree...')
    subprocess.check_call(base + ['--out', dump_b], cwd=repo, env=env(repo))
    # compare and cross run here, in the working tree's own tool
    rc = cmd_compare(argparse.Namespace(a=dump_a, b=dump_b, payload_only=args.payload_only))
    if not args.payload_only:
        # cross-decoding other-version containers is impossible by design
        rc |= cmd_cross(argparse.Namespace(a=dump_a, cpu=args.cpu))
    print('ab: PASS — streams and volumes byte-identical vs HEAD, and '
          'HEAD streams cross-decode' if rc == 0 else
          'ab: FAIL — see mismatches above')
    return rc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU (the kernels\' plain versions; kernel '
                        'changes still need the card)')
    sub = p.add_subparsers(dest='cmd', required=True)

    def common(sp):
        sp.add_argument('--shape', type=int, nargs=3, default=[16, 24, 36])
        sp.add_argument('--L', type=int, default=6)
        sp.add_argument('--k', type=int, default=3)
        sp.add_argument('--seed', type=int, default=0)
        sp.add_argument('--batch', type=int, default=8)
        sp.add_argument('--impl', default='cuda',
                        choices=['cuda', 'cuda_planar'])
        sp.add_argument('--bsubs', type=int, nargs='+', default=list(_PORTED_BSUBS))

    sp = sub.add_parser('dump')
    common(sp)
    sp.add_argument('--out', required=True)
    sp.set_defaults(fn=cmd_dump)
    sp = sub.add_parser('compare')
    sp.add_argument('a')
    sp.add_argument('b')
    sp.add_argument('--payload-only', action='store_true', dest='payload_only')
    sp.set_defaults(fn=cmd_compare)
    sp = sub.add_parser('cross')
    sp.add_argument('a')
    sp.set_defaults(fn=cmd_cross)
    sp = sub.add_parser('ab')
    common(sp)
    sp.add_argument('--worktree', default=None)
    sp.add_argument('--payload-only', action='store_true', dest='payload_only',
                    help='compare parsed words/states/crc instead of raw '
                         'container bytes (for changes that bump the '
                         'container version; skips the cross-decode step)')
    sp.set_defaults(fn=cmd_ab)
    args = p.parse_args(argv)
    return args.fn(args) or 0


if __name__ == '__main__':
    sys.exit(main())
