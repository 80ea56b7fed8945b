// tpurt native host kernels (C++).
//
// The reference keeps its performance-critical host paths in native code
// (Rust SIMD pixel permutation, gltf_model_reader.rs:576-633; the driver's
// BLAS builder behind vk_blas_builder.rs:88). These are their C++
// equivalents, exposed through a C ABI for ctypes:
//   - pixel channel permutation (vectorizable shuffle loop),
//   - vertex-attribute interleaving (the asset-upload hot loop),
//   - 30-bit Morton encoding,
//   - binned-SAH BVH build emitting the skip-link FlatBVH layout.
//
// Build: see tpurt/native/build.py (g++ -O3 -march=native -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- permute --

// Permute channels of `n_texels` texels from src (src_ts bytes/texel) into
// dst (dst_ts bytes/texel). map[i] = destination byte of source byte i, or -1
// to drop. Unmapped destination bytes are zero.
void tpurt_permute_pixels(const uint8_t* src, uint8_t* dst, int64_t n_texels,
                          int src_ts, int dst_ts, const int8_t* map) {
    // Specialized fast path: same-size 4-byte texels (the common RGBA<->BGRA
    // case); compilers vectorize this shuffle well with -O3 -march=native.
    if (src_ts == 4 && dst_ts == 4) {
        uint8_t m[4] = {0, 0, 0, 0};
        uint8_t used[4] = {0, 0, 0, 0};
        for (int i = 0; i < 4; i++)
            if (map[i] >= 0) { m[map[i]] = (uint8_t)i; used[map[i]] = 1; }
        for (int64_t t = 0; t < n_texels; t++) {
            const uint8_t* s = src + t * 4;
            uint8_t* d = dst + t * 4;
            uint8_t o0 = used[0] ? s[m[0]] : 0;
            uint8_t o1 = used[1] ? s[m[1]] : 0;
            uint8_t o2 = used[2] ? s[m[2]] : 0;
            uint8_t o3 = used[3] ? s[m[3]] : 0;
            d[0] = o0; d[1] = o1; d[2] = o2; d[3] = o3;
        }
        return;
    }
    std::memset(dst, 0, (size_t)n_texels * dst_ts);
    for (int64_t t = 0; t < n_texels; t++) {
        const uint8_t* s = src + t * src_ts;
        uint8_t* d = dst + t * dst_ts;
        for (int i = 0; i < src_ts; i++) {
            int8_t j = map[i];
            if (j >= 0 && j < dst_ts) d[j] = s[i];
        }
    }
}

// ------------------------------------------------------------- interleave --

// Interleave n_attrs strided attribute streams into one packed vertex stream
// (the reference's per-vertex copy loop, gltf_model_reader.rs:180-195).
void tpurt_interleave(const uint8_t** srcs, const int64_t* strides,
                      const int64_t* sizes, int n_attrs, int64_t count,
                      uint8_t* dst) {
    int64_t out_stride = 0;
    for (int a = 0; a < n_attrs; a++) out_stride += sizes[a];
    for (int64_t i = 0; i < count; i++) {
        uint8_t* d = dst + i * out_stride;
        for (int a = 0; a < n_attrs; a++) {
            std::memcpy(d, srcs[a] + i * strides[a], (size_t)sizes[a]);
            d += sizes[a];
        }
    }
}

// ----------------------------------------------------------------- morton --

static inline uint32_t expand_bits_10(uint32_t v) {
    v = (v * 0x00010001u) & 0xFF0000FFu;
    v = (v * 0x00000101u) & 0x0F00F00Fu;
    v = (v * 0x00000011u) & 0xC30C30C3u;
    v = (v * 0x00000005u) & 0x49249249u;
    return v;
}

void tpurt_morton3d(const float* pts, int64_t n, const float* lo,
                    const float* hi, uint32_t* out) {
    float ext[3];
    for (int k = 0; k < 3; k++) {
        ext[k] = hi[k] - lo[k];
        if (ext[k] < 1e-12f) ext[k] = 1e-12f;
    }
    for (int64_t i = 0; i < n; i++) {
        uint32_t q[3];
        for (int k = 0; k < 3; k++) {
            float p = (pts[i * 3 + k] - lo[k]) / ext[k];
            p = std::min(std::max(p, 0.0f), 1.0f);
            q[k] = (uint32_t)std::min(p * 1024.0f, 1023.0f);
        }
        out[i] = (expand_bits_10(q[0]) << 2) | (expand_bits_10(q[1]) << 1)
                 | expand_bits_10(q[2]);
    }
}

// -------------------------------------------------------------- SAH build --

namespace {

constexpr int kBins = 16;

struct BuildCtx {
    const float* amin;
    const float* amax;
    std::vector<float> cent;   // (n,3)
    int32_t* order;
    int max_leaf;
    // output arrays (capacity 2n)
    float* node_min;
    float* node_max;
    int32_t* entry;
    int32_t* skip;
    int32_t* first;
    int32_t* count;
    std::vector<int32_t> subtree_end;
    int32_t n_nodes = 0;
};

static inline float half_area(const float* mn, const float* mx) {
    float dx = std::max(mx[0] - mn[0], 0.0f);
    float dy = std::max(mx[1] - mn[1], 0.0f);
    float dz = std::max(mx[2] - mn[2], 0.0f);
    return dx * dy + dy * dz + dz * dx;
}

static void build_range(BuildCtx& c, int32_t lo, int32_t hi) {
    int32_t node = c.n_nodes++;
    float bmin[3] = {3e38f, 3e38f, 3e38f};
    float bmax[3] = {-3e38f, -3e38f, -3e38f};
    float cmin[3] = {3e38f, 3e38f, 3e38f};
    float cmax[3] = {-3e38f, -3e38f, -3e38f};
    for (int32_t i = lo; i < hi; i++) {
        int32_t t = c.order[i];
        for (int k = 0; k < 3; k++) {
            bmin[k] = std::min(bmin[k], c.amin[t * 3 + k]);
            bmax[k] = std::max(bmax[k], c.amax[t * 3 + k]);
            cmin[k] = std::min(cmin[k], c.cent[t * 3 + k]);
            cmax[k] = std::max(cmax[k], c.cent[t * 3 + k]);
        }
    }
    std::memcpy(c.node_min + node * 3, bmin, 12);
    std::memcpy(c.node_max + node * 3, bmax, 12);
    c.entry[node] = -1;
    c.first[node] = -1;
    c.count[node] = 0;
    c.subtree_end.push_back(0);

    int32_t n = hi - lo;
    if (n <= c.max_leaf) {
        c.first[node] = lo;
        c.count[node] = n;
        c.subtree_end[node] = c.n_nodes;
        return;
    }

    // widest centroid axis
    int axis = 0;
    float ext[3];
    for (int k = 0; k < 3; k++) ext[k] = cmax[k] - cmin[k];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int32_t mid = -1;
    if (ext[axis] > 1e-12f) {
        // binned SAH sweep
        float bin_min[kBins][3], bin_max[kBins][3];
        int32_t bin_cnt[kBins] = {0};
        for (int b = 0; b < kBins; b++)
            for (int k = 0; k < 3; k++) { bin_min[b][k] = 3e38f; bin_max[b][k] = -3e38f; }
        float scale = kBins / ext[axis];
        auto bin_of = [&](int32_t t) {
            int b = (int)((c.cent[t * 3 + axis] - cmin[axis]) * scale);
            return std::min(std::max(b, 0), kBins - 1);
        };
        for (int32_t i = lo; i < hi; i++) {
            int32_t t = c.order[i];
            int b = bin_of(t);
            bin_cnt[b]++;
            for (int k = 0; k < 3; k++) {
                bin_min[b][k] = std::min(bin_min[b][k], c.amin[t * 3 + k]);
                bin_max[b][k] = std::max(bin_max[b][k], c.amax[t * 3 + k]);
            }
        }
        // suffix sweep
        float rmin[kBins][3], rmax[kBins][3];
        int32_t rcnt[kBins];
        for (int k = 0; k < 3; k++) { rmin[kBins - 1][k] = bin_min[kBins - 1][k]; rmax[kBins - 1][k] = bin_max[kBins - 1][k]; }
        rcnt[kBins - 1] = bin_cnt[kBins - 1];
        for (int b = kBins - 2; b >= 0; b--) {
            rcnt[b] = rcnt[b + 1] + bin_cnt[b];
            for (int k = 0; k < 3; k++) {
                rmin[b][k] = std::min(bin_min[b][k], rmin[b + 1][k]);
                rmax[b][k] = std::max(bin_max[b][k], rmax[b + 1][k]);
            }
        }
        // prefix sweep + cost
        float lmin[3] = {3e38f, 3e38f, 3e38f}, lmax[3] = {-3e38f, -3e38f, -3e38f};
        int32_t lcnt = 0;
        float best_cost = 3e38f;
        int best_split = -1;
        for (int b = 0; b < kBins - 1; b++) {
            lcnt += bin_cnt[b];
            for (int k = 0; k < 3; k++) {
                lmin[k] = std::min(lmin[k], bin_min[b][k]);
                lmax[k] = std::max(lmax[k], bin_max[b][k]);
            }
            if (lcnt == 0 || rcnt[b + 1] == 0) continue;
            float cost = half_area(lmin, lmax) * lcnt
                         + half_area(rmin[b + 1], rmax[b + 1]) * rcnt[b + 1];
            if (cost < best_cost) { best_cost = cost; best_split = b; }
        }
        if (best_split >= 0) {
            auto pred = [&](int32_t t) { return bin_of(t) <= best_split; };
            int32_t* beg = c.order + lo;
            int32_t* end = c.order + hi;
            int32_t* m = std::partition(beg, end, pred);
            mid = lo + (int32_t)(m - beg);
            if (mid == lo || mid == hi) mid = -1;
        }
    }
    if (mid < 0) {
        // median split on widest axis
        std::nth_element(c.order + lo, c.order + lo + n / 2, c.order + hi,
                         [&](int32_t a, int32_t b) {
                             return c.cent[a * 3 + axis] < c.cent[b * 3 + axis];
                         });
        mid = lo + n / 2;
    }
    c.entry[node] = c.n_nodes;
    build_range(c, lo, mid);
    build_range(c, mid, hi);
    c.subtree_end[node] = c.n_nodes;
}

}  // namespace

// Binned-SAH build over n item AABBs. Output buffers must hold 2n entries
// (3*2n floats for node_min/node_max). Returns the node count.
int32_t tpurt_build_sah(const float* amin, const float* amax, int32_t n,
                        int32_t max_leaf, float* node_min, float* node_max,
                        int32_t* entry, int32_t* skip, int32_t* first,
                        int32_t* count, int32_t* order) {
    if (n <= 0) return 0;
    BuildCtx c;
    c.amin = amin;
    c.amax = amax;
    c.cent.resize((size_t)n * 3);
    for (int64_t i = 0; i < n; i++)
        for (int k = 0; k < 3; k++)
            c.cent[i * 3 + k] = 0.5f * (amin[i * 3 + k] + amax[i * 3 + k]);
    for (int32_t i = 0; i < n; i++) order[i] = i;
    c.order = order;
    c.max_leaf = max_leaf;
    c.node_min = node_min;
    c.node_max = node_max;
    c.entry = entry;
    c.skip = skip;
    c.first = first;
    c.count = count;
    c.subtree_end.reserve((size_t)2 * n);
    build_range(c, 0, n);
    for (int32_t i = 0; i < c.n_nodes; i++)
        skip[i] = (c.subtree_end[i] == c.n_nodes) ? -1 : c.subtree_end[i];
    return c.n_nodes;
}

}  // extern "C"

// ------------------------------------------------------------ buddy arena --
//
// Power-of-two buddy sub-allocator over a linear arena — the host-side
// counterpart of the reference's VkBuffersSubAllocator (free-lists keyed by
// block size, recursive split on allocate and buddy-merge on free). Here
// the arena indexes into preallocated pooled device arrays (XLA owns real
// memory); this manages slot lifetimes for streaming/staging pools.

namespace {

struct BuddyArena {
    int64_t total = 0;
    int64_t min_block = 0;
    int num_orders = 0;
    std::vector<std::vector<int64_t>> free_lists;  // per order: free offsets
    // allocated offset -> order
    std::vector<std::pair<int64_t, int>> live;

    int order_of(int64_t size) const {
        int64_t b = min_block;
        int o = 0;
        while (b < size) { b <<= 1; o++; }
        return o;
    }
    int64_t order_size(int o) const { return min_block << o; }

    bool take(int o, int64_t off) {
        auto& fl = free_lists[o];
        for (size_t i = 0; i < fl.size(); i++) {
            if (fl[i] == off) { fl[i] = fl.back(); fl.pop_back(); return true; }
        }
        return false;
    }
};

}  // namespace

extern "C" void* tpurt_buddy_create(int64_t total_size, int64_t min_block) {
    if (min_block <= 0 || total_size < min_block) return nullptr;
    // round min_block up to a power of two; total down to a multiple shape
    int64_t mb = 1;
    while (mb < min_block) mb <<= 1;
    int64_t tot = mb;
    while (tot * 2 <= total_size) tot <<= 1;
    auto* a = new BuddyArena();
    a->min_block = mb;
    a->total = tot;
    a->num_orders = a->order_of(tot) + 1;
    a->free_lists.assign(a->num_orders, {});
    a->free_lists[a->num_orders - 1].push_back(0);
    return a;
}

extern "C" int64_t tpurt_buddy_alloc(void* h, int64_t size, int64_t alignment) {
    auto* a = static_cast<BuddyArena*>(h);
    if (!a || size <= 0) return -1;
    if (alignment < 1) alignment = 1;
    if (alignment > size) size = alignment;  // pow2 blocks are size-aligned
    int want = a->order_of(size);
    if (want >= a->num_orders) return -1;
    int o = want;
    while (o < a->num_orders && a->free_lists[o].empty()) o++;
    if (o == a->num_orders) return -1;
    int64_t off = a->free_lists[o].back();
    a->free_lists[o].pop_back();
    // split down to the wanted order, releasing upper halves
    while (o > want) {
        o--;
        a->free_lists[o].push_back(off + a->order_size(o));
    }
    a->live.emplace_back(off, want);
    return off;
}

extern "C" int tpurt_buddy_free(void* h, int64_t offset) {
    auto* a = static_cast<BuddyArena*>(h);
    if (!a) return -1;
    int order = -1;
    for (size_t i = 0; i < a->live.size(); i++) {
        if (a->live[i].first == offset) {
            order = a->live[i].second;
            a->live[i] = a->live.back();
            a->live.pop_back();
            break;
        }
    }
    if (order < 0) return -1;
    // merge with the buddy while possible
    int64_t off = offset;
    int o = order;
    while (o + 1 < a->num_orders) {
        int64_t buddy = off ^ a->order_size(o);
        if (!a->take(o, buddy)) break;
        off = std::min(off, buddy);
        o++;
    }
    a->free_lists[o].push_back(off);
    return 0;
}

extern "C" int64_t tpurt_buddy_free_bytes(void* h) {
    auto* a = static_cast<BuddyArena*>(h);
    if (!a) return 0;
    int64_t s = 0;
    for (int o = 0; o < a->num_orders; o++)
        s += (int64_t)a->free_lists[o].size() * a->order_size(o);
    return s;
}

extern "C" void tpurt_buddy_destroy(void* h) { delete static_cast<BuddyArena*>(h); }
