"""TF1 checkpoint importer: released reference checkpoints -> the port's
modules (port of imgcomp_cvpr_tpu/tools/tf1_import.py, without TensorFlow).

The reference ships three trained models (0515_1103 / 0515_1309 / 0515_1310,
ref README.md:47-49) as TF1 slim checkpoints. ``import_tf1_checkpoint``
maps their variable names onto the JAX package's param / batch-stats trees
(numpy), the layout that ``weights.ae_state_dict`` / ``weights.pc_state_dict``
turn into state dicts of the port's modules.

Name scheme on the TF side (derived from the reference source):
- encoder convs:      autoencoder/encoder/<scope>/weights     [kh,kw,in,out]
  + BatchNorm:        .../<scope>/BatchNorm/{beta,gamma,moving_mean,moving_variance}
  (ref: autoencoder.py:98-125,218-244; scopes h1, h2,
   res_block_enc_{b}/enc_{b}_{i}/conv{j}, res_block_enc_final/conv{j}, to_bn)
- decoder transposes: autoencoder/decoder/<scope>/weights     [kh,kw,out,in]
  (ref: autoencoder.py:246-268; scopes from_bn, res_block_dec_{b}/dec_{b}_{i}/
   conv{j}, dec_after_res/conv{j}, h12, h13)
- centers:            autoencoder/encoder/centers             (ref: quantizer.py:11-15)
- context model:      probclass3d/logits/[res1/]conv3d_<name>_mask/{weights,biases}
  [kd,kh,kw,in,out]   (ref: probclass.py:199-261)

Trees: params['ae'][encoder|decoder][<name>]{'w'},
[...][<name>]['BatchNorm_0']{'scale','bias'};
batch_stats[encoder|decoder][<name>]['BatchNorm_0']{'mean','var'};
params['pc'][conv0|res1/conv1|res1/conv2|conv_out]{'w','b'}.
Transforms: conv2d weights map 1:1 (HWIO); conv2d_transpose weights need a
(0,1,3,2) transpose (TF stores [kh,kw,out,in]); conv3d weights map 1:1.

The checkpoint files are read and written in pure Python (``BundleReader``,
``write_bundle``): TF's tensor-bundle format, ``<prefix>.index`` plus
``<prefix>.data-<shard>-of-<shards>``. The index is a LevelDB-format table
(uncompressed blocks, each with a 5-byte trailer: type byte + masked CRC-32C;
a 48-byte footer: metaindex and index block handles, padding, magic). Its
key "" holds the BundleHeaderProto, and every other key is a tensor name
whose value is a BundleEntryProto: dtype, shape, shard, offset and size in
the data file, and the masked CRC-32C of the tensor's bytes (TF stores it
masked; checked against tf.raw_ops.SaveV2's files). The data files hold the
raw little-endian tensors back to back.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from .make_records import _masked_crc, _varint


def ae_name_pairs(ae_config) -> List[Tuple[str, Tuple[str, ...], bool]]:
    """[(tf_scope, our_path, is_transpose)] for every AE conv."""
    pairs = []

    def enc(scope, our):
        pairs.append((f'autoencoder/encoder/{scope}', ('encoder',) + our, False))

    def dec(scope, our):
        pairs.append((f'autoencoder/decoder/{scope}', ('decoder',) + our, True))

    enc('h1', ('h1',))
    enc('h2', ('h2',))
    for b in range(ae_config.arch_param_B):
        for i in range(1, 4):
            for j in (1, 2):
                enc(f'res_block_enc_{b}/enc_{b}_{i}/conv{j}',
                    (f'res_block_enc_{b}_{i}', f'conv{j}'))
    for j in (1, 2):
        enc(f'res_block_enc_final/conv{j}', ('res_block_enc_final', f'conv{j}'))
    enc('to_bn', ('to_bn',))

    dec('from_bn', ('from_bn',))
    for b in range(ae_config.arch_param_B):
        for i in range(1, 4):
            for j in (1, 2):
                dec(f'res_block_dec_{b}/dec_{b}_{i}/conv{j}',
                    (f'res_block_dec_{b}_{i}', f'conv{j}'))
    for j in (1, 2):
        dec(f'dec_after_res/conv{j}', ('dec_after_res', f'conv{j}'))
    dec('h12', ('h12',))
    dec('h13', ('h13',))
    return pairs


def pc_name_pairs() -> List[Tuple[str, Tuple[str, ...]]]:
    return [
        ('probclass3d/logits/conv3d_conv0_mask', ('conv0',)),
        ('probclass3d/logits/res1/conv3d_conv1_mask', ('res1', 'conv1')),
        ('probclass3d/logits/res1/conv3d_conv2_mask', ('res1', 'conv2')),
        ('probclass3d/logits/conv3d_conv2_mask', ('conv_out',)),
    ]


def expected_names(ae_config) -> List[str]:
    """Every TF1 variable name the importer will read for this config —
    the checkpoint-side contract, computable with no tensor values (so a
    var_names.pkl manifest alone can validate the mapping; ref
    saver.py:19-43 pickles exactly this name list next to each ckpt)."""
    names = ['autoencoder/encoder/centers']
    for tf_scope, _our, _t in ae_name_pairs(ae_config):
        names.append(f'{tf_scope}/weights')
        for bn in ('gamma', 'beta', 'moving_mean', 'moving_variance'):
            names.append(f'{tf_scope}/BatchNorm/{bn}')
    for tf_scope, _our in pc_name_pairs():
        names.append(f'{tf_scope}/weights')
        names.append(f'{tf_scope}/biases')
    return names


# Checkpoint variables that are training state, not model weights — the
# importer never reads these and a manifest check must not count them
# (TF1 slim training state: Adam slots/power accumulators, step counter,
# EMA copies).
SKIP_VAR_SUBSTRINGS = ('Adam', 'beta1_power', 'beta2_power', 'global_step',
                       'ExponentialMovingAverage', 'Momentum', 'RMSProp')


# -- TF's tensor-bundle checkpoint format ---------------------------------------

# DataType enum values (tensorflow/core/framework/types.proto) of the
# numeric types a model checkpoint holds.
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
           6: np.int8, 9: np.int64, 10: np.bool_, 17: np.uint16, 19: np.float16,
           22: np.uint32, 23: np.uint64}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}
_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48                        # 2 block handles padded to 40, magic
_BLOCK_SIZE = 262144                    # TF table_options.h defaults
_RESTART_INTERVAL = 16


def _len_delim_varint(field: int, v: int) -> bytes:
    """Length and body of a message whose one varint field is ``v`` (proto3:
    a zero is not written)."""
    body = (_varint(field << 3) + _varint(v)) if v else b''
    return _varint(len(body)) + body


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _proto_fields(buf: bytes):
    """(field number, wire type, value) of a serialized proto message;
    value is an int (varint, fixed) or bytes (length-delimited)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            v, pos = struct.unpack_from('<Q', buf, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            v, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            v, pos = struct.unpack_from('<I', buf, pos)[0], pos + 4
        else:
            raise ValueError(f'unsupported proto wire type {wire}')
        yield field, wire, v


def _block_entries(block: bytes):
    """(key, value) of a table block (LevelDB format: prefix-compressed keys,
    restart array and its count at the end)."""
    n_restarts = struct.unpack_from('<I', block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    pos, key = 0, b''
    while pos < end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        vlen, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + vlen]
        pos += vlen


def _read_block(f, handle: bytes) -> bytes:
    offset, pos = _read_varint(handle, 0)
    size, _ = _read_varint(handle, pos)
    f.seek(offset)
    raw = f.read(size + 5)
    if len(raw) != size + 5:
        raise ValueError('truncated checkpoint index')
    if raw[size] != 0:
        raise ValueError(f'compressed index block (type {raw[size]}) is not supported')
    if struct.unpack_from('<I', raw, size + 1)[0] != _masked_crc(raw[:size + 1]):
        raise ValueError('checkpoint index block fails its CRC')
    return raw[:size]


class BundleReader:
    """Reads a tensor-bundle checkpoint (``<prefix>.index`` + data files):
    the counterpart of ``tf.train.load_checkpoint(prefix)``'s reader."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + '.index', 'rb') as f:
            f.seek(0, os.SEEK_END)
            if f.tell() < _FOOTER_LEN:
                raise ValueError(f'{prefix}.index: not a checkpoint index')
            f.seek(-_FOOTER_LEN, os.SEEK_END)
            footer = f.read(_FOOTER_LEN)
            if struct.unpack_from('<Q', footer, 40)[0] != _TABLE_MAGIC:
                raise ValueError(f'{prefix}.index: bad table magic')
            _, pos = _read_varint(footer, 0)          # metaindex handle (unused)
            _, pos = _read_varint(footer, pos)
            index_block = _read_block(f, footer[pos:])
            entries = {}
            for _, handle in _block_entries(index_block):
                for key, value in _block_entries(_read_block(f, handle)):
                    entries[key.decode()] = value
        header = dict((fld, v) for fld, _, v in _proto_fields(entries.pop('', b'')))
        self.num_shards = header.get(1, 0)
        if header.get(2, 0) != 0:
            raise ValueError(f'{prefix}: big-endian checkpoints are not supported')
        self._entries = {name: self._parse_entry(name, v) for name, v in entries.items()}

    @staticmethod
    def _parse_entry(name: str, buf: bytes) -> Dict:
        e = {'dtype': 0, 'shape': (), 'shard': 0, 'offset': 0, 'size': 0, 'crc': 0}
        for field, _, v in _proto_fields(buf):
            if field == 1:
                e['dtype'] = v
            elif field == 2:
                dims = []
                for f2, _, d in _proto_fields(v):
                    if f2 == 3 and d:
                        raise ValueError(f'{name}: unknown rank')
                    if f2 == 2:
                        dims.append(dict((k, x) for k, _, x in _proto_fields(d)).get(1, 0))
                e['shape'] = tuple(dims)
            elif field in (3, 4, 5):
                e[{3: 'shard', 4: 'offset', 5: 'size'}[field]] = v
            elif field == 6:
                e['crc'] = v
            elif field == 7:
                raise ValueError(f'{name}: partitioned (sliced) variables are not supported')
        return e

    def get_variable_to_shape_map(self) -> Dict[str, Tuple[int, ...]]:
        return {name: e['shape'] for name, e in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        e = self._entries[name]
        if e['dtype'] not in _DTYPES:
            raise ValueError(f'{name}: dtype {e["dtype"]} is not supported')
        data_path = f'{self.prefix}.data-{e["shard"]:05d}-of-{self.num_shards:05d}'
        with open(data_path, 'rb') as f:
            f.seek(e['offset'])
            raw = f.read(e['size'])
        if len(raw) != e['size'] or _masked_crc(raw) != e['crc']:
            raise ValueError(f'{name}: data fails its CRC in {data_path}')
        return np.frombuffer(raw, np.dtype(_DTYPES[e['dtype']]).newbyteorder('<')
                             ).reshape(e['shape']).astype(_DTYPES[e['dtype']])


def _block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """A table block of (key, value) pairs in key order."""
    out, restarts, last = bytearray(), [], b''
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % _RESTART_INTERVAL:
            while shared < min(len(key), len(last)) and key[shared] == last[shared]:
                shared += 1
        else:
            restarts.append(len(out))
        out += (_varint(shared) + _varint(len(key) - shared) + _varint(len(value))
                + key[shared:] + value)
        last = key
    restarts = restarts or [0]
    return bytes(out) + struct.pack(f'<{len(restarts)}I', *restarts) + struct.pack(
        '<I', len(restarts))


def _short_successor(key: bytes) -> bytes:
    """The shortest key >= ``key``: its first byte that is not 0xff, plus one
    (TF's table_builder FindShortSuccessor)."""
    for i, b in enumerate(key):
        if b != 0xFF:
            return key[:i] + bytes([b + 1])
    return key


def write_bundle(tensors: Dict[str, np.ndarray], prefix: str) -> str:
    """Write ``tensors`` as a one-shard tensor-bundle checkpoint at ``prefix``,
    tensors in name order: byte for byte what tf.raw_ops.SaveV2 writes for
    them. The index is one data block (_BLOCK_SIZE bytes, some 4,000
    variables; the AE + context model trees hold a few hundred): a larger
    one raises."""
    names = sorted(tensors)
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    rows, offset = [(b'', b'\x08\x01\x1a\x02\x08\x01')], 0  # 1 shard, little-endian, version 1
    with open(prefix + '.data-00000-of-00001', 'wb') as f:
        for name in names:
            a = np.asarray(tensors[name])
            if a.dtype not in _DTYPE_IDS:
                raise ValueError(f'{name}: dtype {a.dtype} is not supported')
            raw = np.ascontiguousarray(a, a.dtype.newbyteorder('<')).tobytes()
            f.write(raw)
            dims = b''.join(b'\x12' + _len_delim_varint(1, d) for d in a.shape)
            entry = (b'\x08' + _varint(_DTYPE_IDS[a.dtype]) + b'\x12' + _varint(len(dims))
                     + dims + (b'\x20' + _varint(offset) if offset else b'')
                     + (b'\x28' + _varint(len(raw)) if raw else b'')
                     + b'\x35' + struct.pack('<I', _masked_crc(raw)))
            rows.append((name.encode(), entry))
            offset += len(raw)
    # One data block, then the (empty) metaindex, the index (the last key's
    # short successor) and the footer.
    if sum(len(k) + len(v) + 3 for k, v in rows) >= _BLOCK_SIZE:
        raise ValueError(f'{len(names)} tensors: the index would need more than one '
                         'data block')
    out = bytearray()

    def put(block: bytes) -> bytes:
        handle = _varint(len(out)) + _varint(len(block))
        out.extend(block + b'\x00' + struct.pack('<I', _masked_crc(block + b'\x00')))
        return handle

    index = [(_short_successor(rows[-1][0]), put(_block(rows)))]
    meta = put(_block([]))
    idx = put(_block(index))
    footer = meta + idx
    out.extend(footer + b'\x00' * (40 - len(footer)) + struct.pack('<Q', _TABLE_MAGIC))
    with open(prefix + '.index', 'wb') as f:
        f.write(out)
    return prefix


# -- import / export ----------------------------------------------------------------

def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value, np.float32)


def import_tf1_checkpoint(ckpt_path: str, ae_config, pc_config):
    """Returns (params, batch_stats) trees of numpy arrays in the JAX
    package's layout; ``weights.ae_state_dict(params['ae'], batch_stats,
    ae)`` and ``weights.pc_state_dict(params['pc'])`` load them.

    ckpt_path: prefix of a TF1 checkpoint (e.g. '.../ckpts/ckpt-<itr>').
    """
    reader = BundleReader(ckpt_path)

    def get(name):
        return reader.get_tensor(name)

    ae_params: Dict = {}
    batch_stats: Dict = {}

    _set(ae_params, ('encoder', 'centers'), get('autoencoder/encoder/centers'))
    for tf_scope, our_path, is_transpose in ae_name_pairs(ae_config):
        w = get(f'{tf_scope}/weights')
        if is_transpose:
            w = np.transpose(w, (0, 1, 3, 2))  # [kh,kw,out,in] -> [kh,kw,in,out]
        _set(ae_params, our_path + ('w',), w)
        _set(ae_params, our_path + ('BatchNorm_0', 'scale'),
             get(f'{tf_scope}/BatchNorm/gamma'))
        _set(ae_params, our_path + ('BatchNorm_0', 'bias'),
             get(f'{tf_scope}/BatchNorm/beta'))
        _set(batch_stats, our_path + ('BatchNorm_0', 'mean'),
             get(f'{tf_scope}/BatchNorm/moving_mean'))
        _set(batch_stats, our_path + ('BatchNorm_0', 'var'),
             get(f'{tf_scope}/BatchNorm/moving_variance'))

    pc_params: Dict = {}
    for tf_scope, our_path in pc_name_pairs():
        _set(pc_params, our_path + ('w',), get(f'{tf_scope}/weights'))
        _set(pc_params, our_path + ('b',), get(f'{tf_scope}/biases'))

    return {'ae': ae_params, 'pc': pc_params}, batch_stats


def export_tensors(params, batch_stats, ae_config) -> Dict[str, np.ndarray]:
    """Trees in the JAX package's layout -> {tf1_variable_name: value} under
    the reference's exact naming scheme (the inverse mapping;
    ``weights.ae_trees`` / ``pc_tree`` give the trees of the port's modules)."""

    def getp(tree, path):
        node = tree
        for p in path:
            node = node[p]
        return np.asarray(node)

    tensors = {'autoencoder/encoder/centers': getp(params, ('ae', 'encoder', 'centers'))}
    for tf_scope, our_path, is_transpose in ae_name_pairs(ae_config):
        w = getp(params, ('ae',) + our_path + ('w',))
        if is_transpose:
            w = np.transpose(w, (0, 1, 3, 2))
        tensors[f'{tf_scope}/weights'] = w
        tensors[f'{tf_scope}/BatchNorm/gamma'] = getp(
            params, ('ae',) + our_path + ('BatchNorm_0', 'scale'))
        tensors[f'{tf_scope}/BatchNorm/beta'] = getp(
            params, ('ae',) + our_path + ('BatchNorm_0', 'bias'))
        tensors[f'{tf_scope}/BatchNorm/moving_mean'] = getp(
            batch_stats, our_path + ('BatchNorm_0', 'mean'))
        tensors[f'{tf_scope}/BatchNorm/moving_variance'] = getp(
            batch_stats, our_path + ('BatchNorm_0', 'var'))
    for tf_scope, our_path in pc_name_pairs():
        tensors[f'{tf_scope}/weights'] = getp(params, ('pc',) + our_path + ('w',))
        tensors[f'{tf_scope}/biases'] = getp(params, ('pc',) + our_path + ('b',))
    return tensors


def export_tf1_checkpoint(params, batch_stats, ae_config, out_prefix: str) -> str:
    """Inverse mapping (testing aid + migration tool): write the trees as a
    TF checkpoint with the reference's variable names."""
    return write_bundle(export_tensors(params, batch_stats, ae_config), out_prefix)
