"""End-to-end learner throughput, `rssm.impl: pallas` against `scan`, on
the card: the port of `scripts/fused_impl_bench.py`.

The kernel check times the fused observe chain (observe_fwd and
observe_bwd) on its own; this measures what it buys the whole update on the
learner's path (`bench.measure_updates`: K updates a dispatch from the
device ring) at the a1 (K = 64) and xarm (K = 16) training shapes. Each arm
reports its updates/s, first dispatch and MFU (both arms divided by the
same loop-path count of the update's work), and `speedup` is pallas over
scan. In the pallas arm observe_fwd and observe_bwd must launch once a
timed update. It only measures: the port's `configs.yaml` keeps the JAX
package's defaults.

Usage:
  python -m daydreamer_tpu_torch.scripts.fused_impl_bench [--out FILE] \\
      [--device cuda|cpu]
"""

import argparse
import json
import pathlib

from . import bench

KERNELS = ('observe_fwd', 'observe_bwd')


def run_shape(name, task, overrides, K, budget, device='cuda'):
  return bench.compare_impls(name, 'rssm.impl', task, overrides, K, budget,
                             device, KERNELS)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--out', default='')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  args = parser.parse_args(argv)
  device = bench.resolve_device(args.device)
  result = {'kernel_build': bench.kernel_build(device),
            'device': bench.describe(device)}
  for shape, K in (('a1', 64), ('xarm', 16)):
    task, overrides, _ = bench.SHAPES[shape]
    result[shape] = run_shape(shape, task, overrides, K, 90.0, device)
  if device.type == 'cuda':
    print(bench.card(), flush=True)
  if args.out:
    pathlib.Path(args.out).write_text(json.dumps(result, indent=2) + '\n')
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
