"""The port's subpacket traversal (``ops.traverse_subpacket``,
``TraversalMode.BVH_SUBPACKET``) on the CPU: the cases of
``test_torch_traverse_shared.PacketKernelCases`` (twin = plain version bit
for bit, plain version = brute force, the port against the JAX package's
kernel in interpret mode, a hit exactly at t_max not committed, the stack
bound), and the orders that set the subpacket kernel apart."""

import numpy as np
import torch

from test_torch_traverse_shared import PacketKernelCases, _port_tree, _rays, _t
from vulkanraytracing_torch.ops import traverse_subpacket as tsub
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_tpu.ops import traverse_subpacket as jsub

torch.set_num_threads(1)


class TestSubpacket(PacketKernelCases):
    port = tsub
    jax_mod = jsub

    def test_packets_are_independent(self):
        """A packet is 128 consecutive rays: the results of a packet do not
        depend on the other packets of the call, so the order in which the
        kernel's blocks take them cannot change them."""
        _, bvh, extent = _port_tree("cornell")
        o, d, tmin, tmax = _rays(512, extent, seed=8)
        tmax[::7] = 0.0
        rays = _t((o, d, tmin, tmax))
        table = tw2.get_table2(bvh)
        whole = tsub.closest_plain(table, *rays)
        blocked = tsub.any_plain(table, *rays)
        for part in (slice(0, 128), slice(256, 512)):
            alone = tsub.closest_plain(table, *[x[part] for x in rays])
            for name, a, b in zip(alone._fields, alone, whole):
                assert torch.equal(a, b[part]), name
            assert torch.equal(tsub.any_plain(table, *[x[part] for x in rays]), blocked[part])
        assert np.count_nonzero(whole.is_hit.numpy()) > 100
