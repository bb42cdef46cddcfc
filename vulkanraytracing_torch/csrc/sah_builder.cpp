// Binned-SAH BVH builder — the native (C++) acceleration-structure builder.
//
// The reference delegates BVH construction to the Vulkan driver with
// ePreferFastTrace (AccelerationStructureManager.cpp:15,95), which builds
// high-quality SAH trees.  The on-device LBVH (accel/lbvh.py) is fast to
// build and refit but its trees cost ~1.5-2x more traversal steps on
// architectural scenes; this builder is the quality path for static
// geometry, invoked at scene-load time through ctypes (accel/sah.py).
//
// Output layout matches the JAX traversal kernels exactly:
//  - internal node i stores child AABBs + child ids (>=0 internal,
//    <0 leaf with ~id = (start << 4 | count) over the reordered tris);
//  - node 0 is the root; tri_order maps new position -> original id.
//
// Algorithm: top-down binned SAH (16 bins on the centroid extent's longest
// axes, all 3 axes scanned), leaf when count <= leaf_size or splitting is
// not profitable (SAH cost >= leaf cost) — with a fallback median split so
// degenerate distributions still terminate.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AABB {
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};

    void grow(const AABB& o) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], o.lo[a]);
            hi[a] = std::max(hi[a], o.hi[a]);
        }
    }
    void grow_point(const float* p) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], p[a]);
            hi[a] = std::max(hi[a], p[a]);
        }
    }
    float half_area() const {
        const float dx = std::max(hi[0] - lo[0], 0.f);
        const float dy = std::max(hi[1] - lo[1], 0.f);
        const float dz = std::max(hi[2] - lo[2], 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    static constexpr int kBins = 16;

    const float* tri_lo;
    const float* tri_hi;
    const float* centroid;
    int leaf_size;

    std::vector<int> order;        // current permutation (new -> original)
    std::vector<int> child_index;  // 2 per internal node
    std::vector<float> child_box;  // 12 per internal node (lo0 hi0 lo1 hi1)

    AABB tri_box(int id) const {
        AABB b;
        for (int a = 0; a < 3; ++a) {
            b.lo[a] = tri_lo[id * 3 + a];
            b.hi[a] = tri_hi[id * 3 + a];
        }
        return b;
    }

    AABB range_box(int start, int count) const {
        AABB b;
        for (int i = start; i < start + count; ++i) b.grow(tri_box(order[i]));
        return b;
    }

    static int encode_leaf(int start, int count) {
        return ~((start << 4) | count);
    }

    // returns node id (>=0) or leaf code (<0)
    int build(int start, int count, const AABB& bounds) {
        if (count <= leaf_size) return encode_leaf(start, count);

        // centroid bounds
        AABB cb;
        for (int i = start; i < start + count; ++i)
            cb.grow_point(centroid + order[i] * 3);

        // binned SAH over all 3 axes
        int best_axis = -1, best_bin = -1;
        float best_cost = 1e30f;
        AABB bins[3][kBins];
        int bin_count[3][kBins];
        std::memset(bin_count, 0, sizeof(bin_count));

        float scale[3], cmin[3];
        for (int a = 0; a < 3; ++a) {
            cmin[a] = cb.lo[a];
            const float extent = cb.hi[a] - cb.lo[a];
            scale[a] = extent > 1e-20f ? kBins / extent : 0.f;
        }
        for (int i = start; i < start + count; ++i) {
            const int id = order[i];
            for (int a = 0; a < 3; ++a) {
                int b = (int)((centroid[id * 3 + a] - cmin[a]) * scale[a]);
                b = std::min(std::max(b, 0), kBins - 1);
                bins[a][b].grow(tri_box(id));
                bin_count[a][b]++;
            }
        }
        for (int a = 0; a < 3; ++a) {
            if (scale[a] == 0.f) continue;
            // sweep: cost(split after bin k) = A_left*n_left + A_right*n_right
            AABB left_box[kBins];
            int left_cnt[kBins];
            AABB acc;
            int cnt = 0;
            for (int k = 0; k < kBins - 1; ++k) {
                acc.grow(bins[a][k]);
                cnt += bin_count[a][k];
                left_box[k] = acc;
                left_cnt[k] = cnt;
            }
            AABB racc;
            int rcnt = 0;
            for (int k = kBins - 1; k >= 1; --k) {
                racc.grow(bins[a][k]);
                rcnt += bin_count[a][k];
                const int lc = left_cnt[k - 1];
                if (lc == 0 || rcnt == 0) continue;
                const float cost =
                    left_box[k - 1].half_area() * lc + racc.half_area() * rcnt;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = a;
                    best_bin = k;  // split before bin k
                }
            }
        }

        int mid;
        if (best_axis >= 0) {
            // NOTE: no SAH early-leaf termination — the traversal kernels
            // unroll exactly LEAF_SIZE triangle tests per leaf, so every
            // range larger than leaf_size must split.
            auto* beg = order.data() + start;
            auto* end = beg + count;
            const float axis_min = cmin[best_axis];
            const float axis_scale = scale[best_axis];
            auto* split = std::partition(beg, end, [&](int id) {
                int b = (int)((centroid[id * 3 + best_axis] - axis_min) *
                              axis_scale);
                b = std::min(std::max(b, 0), kBins - 1);
                return b < best_bin;
            });
            mid = (int)(split - order.data());
            if (mid == start || mid == start + count) {
                mid = start + count / 2;  // degenerate: median fallback
                std::nth_element(
                    beg, order.data() + mid, end, [&](int x, int y) {
                        return centroid[x * 3 + best_axis] <
                               centroid[y * 3 + best_axis];
                    });
            }
        } else {
            mid = start + count / 2;  // all centroids identical
        }

        const int node = (int)(child_index.size() / 2);
        child_index.push_back(0);
        child_index.push_back(0);
        child_box.resize(child_box.size() + 12);

        const AABB lb = range_box(start, mid - start);
        const AABB rb = range_box(mid, start + count - mid);
        const int lchild = build(start, mid - start, lb);
        const int rchild = build(mid, start + count - mid, rb);

        child_index[node * 2 + 0] = lchild;
        child_index[node * 2 + 1] = rchild;
        float* cb_out = child_box.data() + node * 12;
        for (int a = 0; a < 3; ++a) {
            cb_out[0 + a] = lb.lo[a];
            cb_out[3 + a] = lb.hi[a];
            cb_out[6 + a] = rb.lo[a];
            cb_out[9 + a] = rb.hi[a];
        }
        return node;
    }
};

}  // namespace

extern "C" {

// Returns the number of internal nodes written, or -1 on error.
// Buffers must be sized: child_index 2*(n-1), child_box 12*(n-1),
// tri_order n (worst case: n-1 internal nodes).
int build_sah_bvh(
    const float* tri_lo, const float* tri_hi, const float* centroids,
    int num_tris, int leaf_size,
    int* child_index_out, float* child_box_out, int* tri_order_out) {
    if (num_tris <= 0 || leaf_size < 1 || leaf_size > 15) return -1;

    Builder b;
    b.tri_lo = tri_lo;
    b.tri_hi = tri_hi;
    b.centroid = centroids;
    b.leaf_size = leaf_size;
    b.order.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) b.order[i] = i;
    b.child_index.reserve(2 * (size_t)num_tris);
    b.child_box.reserve(12 * (size_t)num_tris);

    const AABB root = b.range_box(0, num_tris);
    const int root_id = b.build(0, num_tris, root);

    int n_nodes = (int)(b.child_index.size() / 2);
    if (root_id < 0) {
        // whole scene is one leaf: emit a single node with the leaf twice
        n_nodes = 1;
        child_index_out[0] = root_id;
        child_index_out[1] = root_id;
        for (int a = 0; a < 3; ++a) {
            child_box_out[0 + a] = root.lo[a];
            child_box_out[3 + a] = root.hi[a];
            child_box_out[6 + a] = root.lo[a];
            child_box_out[9 + a] = root.hi[a];
        }
    } else {
        std::memcpy(child_index_out, b.child_index.data(),
                    b.child_index.size() * sizeof(int));
        std::memcpy(child_box_out, b.child_box.data(),
                    b.child_box.size() * sizeof(float));
    }
    std::memcpy(tri_order_out, b.order.data(), num_tris * sizeof(int));
    return n_nodes;
}

}  // extern "C"
