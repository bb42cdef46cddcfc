// BVH2 -> BVH8 collapse — native implementation of accel/bvh8.py.
//
// The collapse runs at scene-load time on the host (it cannot run inside a
// trace), and the pure-Python loop costs seconds on Sponza-scale trees
// (~260k BVH2 nodes); this C++ version is the production path, invoked via
// ctypes with the Python implementation kept as the portable fallback and
// correctness oracle.
//
// Algorithm (identical to the Python version, byte-identical output):
// starting from a BVH2 interior node's two child slots, repeatedly expand
// the interior slot with the largest surface area until 8 slots are filled
// or all are leaves; emit slots sorted by area (descending); BFS over the
// referenced interior children.  Empty slots carry degenerate far boxes
// (lo = hi = +3e38) whose min/max slab test rejects every ray, and child 0.

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

inline float area(const float* b) {
    float dx = b[3] - b[0], dy = b[4] - b[1], dz = b[5] - b[2];
    if (dx < 0) dx = 0;
    if (dy < 0) dy = 0;
    if (dz < 0) dz = 0;
    return 2.0f * (dx * dy + dy * dz + dz * dx);
}

struct Slot {
    float a;
    int c;
    float box[6];
};

constexpr float kBig = 3.0e38f;

}  // namespace

extern "C" int collapse_bvh8(
    const float* nodes,   // (n, 12): c0.lo c0.hi c1.lo c1.hi
    const int* child,     // (n, 2)
    int n,
    float* nodes8,        // (n, 48) out (only the first M rows written)
    int* child8           // (n, 8) out
) {
    if (n <= 0) return 0;
    std::vector<int> order;
    order.reserve(n);
    std::vector<int> remap(n, -1);
    order.push_back(0);
    remap[0] = 0;

    Slot slots[16];
    for (size_t head = 0; head < order.size(); ++head) {
        const int n2 = order[head];
        int count = 0;
        for (int i = 0; i < 2; ++i) {
            Slot& s = slots[count++];
            s.c = child[n2 * 2 + i];
            std::memcpy(s.box, nodes + n2 * 12 + i * 6, 6 * sizeof(float));
            s.a = area(s.box);
        }
        while (count < 8) {
            int best = -1;
            float best_a = -1.0f;
            for (int i = 0; i < count; ++i) {
                if (slots[i].c >= 0 && slots[i].a > best_a) {
                    best = i;
                    best_a = slots[i].a;
                }
            }
            if (best < 0) break;
            const int c = slots[best].c;
            // erase-and-shift (not swap-with-last): keeps insertion order so
            // the stable area sort tie-breaks exactly like the Python oracle
            for (int i = best; i < count - 1; ++i) slots[i] = slots[i + 1];
            --count;
            for (int i = 0; i < 2; ++i) {
                Slot& s = slots[count++];
                s.c = child[c * 2 + i];
                std::memcpy(s.box, nodes + c * 12 + i * 6, 6 * sizeof(float));
                s.a = area(s.box);
            }
        }
        std::stable_sort(slots, slots + count,
                         [](const Slot& x, const Slot& y) { return x.a > y.a; });

        float* nrow = nodes8 + static_cast<size_t>(head) * 48;
        int* crow = child8 + static_cast<size_t>(head) * 8;
        for (int k = 0; k < count; ++k) {
            std::memcpy(nrow + k * 6, slots[k].box, 6 * sizeof(float));
            if (slots[k].c >= 0) {
                if (remap[slots[k].c] < 0) {
                    remap[slots[k].c] = static_cast<int>(order.size());
                    order.push_back(slots[k].c);
                }
                crow[k] = remap[slots[k].c];
            } else {
                crow[k] = slots[k].c;
            }
        }
        for (int k = count; k < 8; ++k) {
            for (int j = 0; j < 6; ++j) nrow[k * 6 + j] = kBig;
            crow[k] = 0;
        }
    }
    return static_cast<int>(order.size());
}
