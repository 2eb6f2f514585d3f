// libtreepack — native pack of SharedTree edit records for the tree fold.
//
// The host half of bulk SharedTree catch-up turns each document's
// sequenced changesets into the forest and edit planes the tree fold reads
// (ops/tree_kernel.py::pack_tree_batch).  The ingestion side encodes a
// document's changeset messages once into the binary record stream below
// (ops/tree_native.py::encode_tree_ops); this library fills the planes from
// those records with no Python object in the loop, bit for bit what the
// Python pack fills, and returns the per-document facts its meta holds.
//
// Record layout (little-endian, packed), one message after another:
//   message header (32 bytes):
//     i32 seq, i32 client_seq, i32 ref_seq, i32 min_seq,
//     i32 client          (index into the document's client table; -1: none)
//     i32 n_edits
//     f64 timestamp
//   then n_edits edits, each a u8 kind and its fields (all i32):
//     1 insert:  parent, field, anchor, n_items, item * n_items
//     2 remove:  n_ids, id * n_ids
//     3 set:     node, value
//     4 move:    parent, field, anchor, n_ids, id * n_ids
//     5 revive:  parent, field, anchor, n_ids, id * n_ids, n_items,
//                item * n_items
//   an item (24 bytes) is one node of the inserted content, in pre-order:
//     i32 node, i32 type, i32 value, i32 removed_seq,
//     i32 up     (the item of this edit whose field holds it; -1: top level)
//     i32 field  (that field; -1 at the top level)
//   value: an index into the document's value table; -1 no value key,
//   -2 a null value.  removed_seq: INT32_MIN when the node carries none.
//   anchor: -1 for the field start.
//
// Node, field, type, value and client ids index the document's own tables,
// numbered by first appearance.  Nodes are numbered in the order the pack
// interns them (the root "" is node 0), so a record's node id IS the row
// the pack gives it: the pack checks that each node it interns is either
// known or the next one, and rejects the stream otherwise.  Values are
// numbered the same way and reach the planes through the caller's
// doc-local -> batch-global map.
//
// API (C ABI, ctypes-consumed; the interpreter lock is released around
// every call):
//   treepack_route(...)      — the routing verdict of one stream
//   treepack_begin(...)      — parse and intern a batch, per-doc facts out
//   treepack_containers(...) — each document's (node, field) containers
//   treepack_finish(...)     — fill the [D, *] planes at the chosen buckets
//   treepack_free(...)       — release a batch

#include <climits>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t kNil = -1;
constexpr int32_t kNoValue = -1;
constexpr int32_t kNotRemoved = INT32_MAX;
constexpr int32_t kRemovedAbsent = INT32_MIN;
constexpr int32_t kNullValue = -2;

constexpr int kInsert = 1, kRemove = 2, kSet = 3, kMove = 4, kRevive = 5;
// the fold's edit kinds (tree_kernel.K_*)
constexpr int32_t kKInsert = 1, kKRemove = 2, kKSet = 3, kKMove = 4;
// fallback reasons, first one wins (tree_kernel._DocPack.mark_fallback)
constexpr int32_t kFbRevive = 1, kFbMultiIdMove = 2, kFbPurgedParent = 3;

constexpr int kMetaFields = 7;
constexpr int kEditFields = 8;

struct Reader {
    const uint8_t* p;
    int64_t len;
    int64_t off = 0;
    bool ok = true;

    int32_t i32() {
        if (off + 4 > len) {
            ok = false;
            return 0;
        }
        int32_t v;
        std::memcpy(&v, p + off, 4);
        off += 4;
        return v;
    }
    uint8_t u8() {
        if (off + 1 > len) {
            ok = false;
            return 0;
        }
        return p[off++];
    }
    void skip(int64_t n) {
        if (n < 0 || off + n > len) {
            ok = false;
            return;
        }
        off += n;
    }
};

struct Item {
    int32_t node, type, value, removed, up, field;
};

bool read_items(Reader& r, std::vector<Item>& items) {
    const int32_t n = r.i32();
    if (!r.ok || n < 0 || r.off + 24 * static_cast<int64_t>(n) > r.len)
        return false;
    items.resize(n);
    for (int32_t j = 0; j < n; ++j) {
        Item& it = items[j];
        it.node = r.i32();
        it.type = r.i32();
        it.value = r.i32();
        it.removed = r.i32();
        it.up = r.i32();
        it.field = r.i32();
        if (it.up >= j || it.up < -1) return false;
    }
    return r.ok;
}

bool read_ids(Reader& r, std::vector<int32_t>& ids) {
    const int32_t n = r.i32();
    if (!r.ok || n < 0 || r.off + 4 * static_cast<int64_t>(n) > r.len)
        return false;
    ids.resize(n);
    for (int32_t j = 0; j < n; ++j) ids[j] = r.i32();
    return r.ok;
}

// One document's pack, before the planes exist.
struct Doc {
    int32_t n_nodes = 1;  // the root
    int32_t header_seq = 0, base_min_seq = 0, boundary = 0, fallback = 0;
    // node rows (the Python pack's node_rows), by node
    std::vector<int32_t> row_cont, row_val, row_vseq, row_iseq, row_rseq;
    std::vector<uint8_t> row_set;
    // containers in interning order
    std::vector<int32_t> cont_node, cont_field;
    std::unordered_map<int64_t, int32_t> cont_of;
    // the links of insert blocks, in edit order (a, b): next[a] = b,
    // prev[b] = a
    std::vector<int32_t> block_links;
    // nested children by container, containers in first-child order
    std::vector<int32_t> chain_cont;
    std::vector<std::vector<int32_t>> chains;
    std::unordered_map<int32_t, int32_t> chain_of;
    std::vector<int32_t> edits;  // kEditFields a row
    // first remover's seq by node, or INT32_MIN
    std::vector<int32_t> removal;

    void fall_back(int32_t reason) {
        if (fallback == 0) fallback = reason;
    }
    // The pack interns a node: known, or the next one.
    bool node(int32_t idx) {
        if (idx < 0 || idx > n_nodes) return false;
        if (idx == n_nodes) ++n_nodes;
        if (static_cast<size_t>(idx) >= row_set.size()) {
            size_t n = static_cast<size_t>(idx) + 1;
            n = n < 2 * row_set.size() ? 2 * row_set.size() : n;
            row_cont.resize(n);
            row_val.resize(n);
            row_vseq.resize(n);
            row_iseq.resize(n);
            row_rseq.resize(n);
            row_set.resize(n, 0);
        }
        return true;
    }
    int32_t container(int32_t node_idx, int32_t field) {
        const int64_t key = (static_cast<int64_t>(node_idx) << 32)
            | static_cast<uint32_t>(field);
        auto it = cont_of.find(key);
        if (it != cont_of.end()) return it->second;
        const int32_t c = static_cast<int32_t>(cont_node.size());
        cont_of.emplace(key, c);
        cont_node.push_back(node_idx);
        cont_field.push_back(field);
        return c;
    }
    void chain_append(int32_t c, int32_t idx) {
        auto it = chain_of.find(c);
        if (it == chain_of.end()) {
            it = chain_of.emplace(c, static_cast<int32_t>(chains.size()))
                     .first;
            chain_cont.push_back(c);
            chains.emplace_back();
        }
        chains[it->second].push_back(idx);
    }
    bool popped(int32_t idx) const {
        return idx >= 0 && static_cast<size_t>(idx) < removal.size()
            && removal[idx] != INT32_MIN && removal[idx] <= boundary;
    }
    void edit_row(int32_t kind, int32_t seq, int32_t cont, int32_t anchor,
                  int32_t first, int32_t tail, int32_t value) {
        const int32_t row[kEditFields] = {kind, seq, cont, anchor, first,
                                          tail, value, -1};
        edits.insert(edits.end(), row, row + kEditFields);
    }
};

bool map_value(int32_t v, const int32_t* vmap, int64_t n_vals,
               int32_t* out) {
    if (v == kNoValue || v == kNullValue) {
        *out = kNoValue;
        return true;
    }
    if (v < 0 || v >= n_vals) return false;
    *out = vmap[v];
    return true;
}

// The removal pre-pass: every remove's ids, first remover wins.
bool note_removals(const uint8_t* buf, int64_t len, Doc& doc) {
    Reader r{buf, len};
    std::vector<int32_t> ids;
    std::vector<Item> items;
    while (r.off < r.len) {
        const int32_t seq = r.i32();
        r.skip(16);
        const int32_t n_edits = r.i32();
        r.skip(8);
        if (!r.ok || n_edits < 0) return false;
        for (int32_t e = 0; e < n_edits; ++e) {
            const int kind = r.u8();
            switch (kind) {
            case kInsert:
                r.skip(12);
                if (!read_items(r, items)) return false;
                break;
            case kRemove:
                if (!read_ids(r, ids)) return false;
                for (int32_t nid : ids) {
                    if (nid < 0) return false;
                    if (static_cast<size_t>(nid) >= doc.removal.size())
                        doc.removal.resize(nid + 1, INT32_MIN);
                    if (doc.removal[nid] == INT32_MIN)
                        doc.removal[nid] = seq;
                }
                break;
            case kSet:
                r.skip(8);
                break;
            case kMove:
                r.skip(12);
                if (!read_ids(r, ids)) return false;
                break;
            case kRevive:
                r.skip(12);
                if (!read_ids(r, ids) || !read_items(r, items)) return false;
                break;
            default:
                return false;
            }
            if (!r.ok) return false;
        }
    }
    return r.ok;
}

// One document's fill (tree_kernel.fill_tree_doc_messages from an empty
// document), into ``doc``.
bool pack_doc(const uint8_t* buf, int64_t len, const int32_t* vmap,
              int64_t n_vals, Doc& doc) {
    if (!note_removals(buf, len, doc)) return false;
    doc.node(0);
    Reader r{buf, len};
    std::vector<int32_t> ids, block;
    std::vector<Item> items;
    while (r.off < r.len) {
        const int32_t seq = r.i32();
        r.skip(8);
        const int32_t min_seq = r.i32();
        r.skip(4);
        const int32_t n_edits = r.i32();
        r.skip(8);
        if (!r.ok || n_edits < 0) return false;
        doc.header_seq = seq > doc.header_seq ? seq : doc.header_seq;
        doc.base_min_seq =
            min_seq > doc.base_min_seq ? min_seq : doc.base_min_seq;
        const size_t rows_before = doc.edits.size();
        for (int32_t e = 0; e < n_edits; ++e) {
            const int kind = r.u8();
            if (kind == kInsert) {
                const int32_t parent = r.i32(), field = r.i32(),
                              anchor = r.i32();
                if (!read_items(r, items) || items.empty()
                    || items[0].up != -1)
                    return false;
                if (doc.popped(parent)) doc.fall_back(kFbPurgedParent);
                if (!doc.node(parent)) return false;
                const int32_t c = doc.container(parent, field);
                block.clear();
                int32_t top = -1;
                auto stamp_top = [&](int32_t i) {
                    doc.row_iseq[i] = seq;
                    doc.row_vseq[i] = seq > 0 ? seq : 0;
                };
                for (const Item& it : items) {
                    int32_t cont = c;
                    if (it.up == -1) {
                        if (top >= 0) stamp_top(top);
                        if (!doc.node(it.node)) return false;
                        top = it.node;
                        block.push_back(it.node);
                    } else {
                        cont = doc.container(items[it.up].node, it.field);
                        if (!doc.node(it.node)) return false;
                        doc.chain_append(cont, it.node);
                    }
                    int32_t v;
                    if (!map_value(it.value, vmap, n_vals, &v)) return false;
                    doc.row_cont[it.node] = cont;
                    doc.row_val[it.node] = v;
                    doc.row_vseq[it.node] = 0;
                    doc.row_iseq[it.node] = 0;
                    doc.row_rseq[it.node] = it.removed == kRemovedAbsent
                        ? kNotRemoved : it.removed;
                    doc.row_set[it.node] = 1;
                }
                stamp_top(top);
                for (const Item& it : items) {
                    doc.row_iseq[it.node] = seq;
                    if (doc.row_val[it.node] != kNoValue)
                        doc.row_vseq[it.node] = seq;
                }
                int32_t a = kNil;
                if (anchor != -1) {
                    if (!doc.node(anchor)) return false;
                    a = anchor;
                }
                for (size_t j = 1; j < block.size(); ++j) {
                    doc.block_links.push_back(block[j - 1]);
                    doc.block_links.push_back(block[j]);
                }
                doc.edit_row(kKInsert, seq, c, a, block.front(), block.back(),
                             kNoValue);
            } else if (kind == kRemove) {
                if (!read_ids(r, ids)) return false;
                for (int32_t nid : ids) {
                    if (!doc.node(nid)) return false;
                    doc.edit_row(kKRemove, seq, 0, kNil, nid, nid, kNoValue);
                }
            } else if (kind == kSet) {
                const int32_t nid = r.i32(), value = r.i32();
                if (!r.ok || !doc.node(nid)) return false;
                int32_t v;
                if (value == -1 || !map_value(value, vmap, n_vals, &v))
                    return false;
                doc.edit_row(kKSet, seq, 0, kNil, nid, nid, v);
            } else if (kind == kMove) {
                const int32_t parent = r.i32(), field = r.i32(),
                              anchor = r.i32();
                if (!read_ids(r, ids)) return false;
                if (ids.size() != 1) {
                    doc.fall_back(kFbMultiIdMove);
                    continue;
                }
                if (!doc.node(parent)) return false;
                const int32_t c = doc.container(parent, field);
                if (!doc.node(ids[0])) return false;
                int32_t a = kNil;
                if (anchor != -1) {
                    if (!doc.node(anchor)) return false;
                    a = anchor;
                }
                doc.edit_row(kKMove, seq, c, a, ids[0], ids[0], kNoValue);
            } else if (kind == kRevive) {
                r.skip(12);
                if (!read_ids(r, ids) || !read_items(r, items)) return false;
                doc.fall_back(kFbRevive);
            } else {
                return false;
            }
            if (!r.ok) return false;
        }
        for (size_t i = rows_before; i < doc.edits.size(); i += kEditFields)
            doc.edits[i + kEditFields - 1] = doc.boundary;
        doc.boundary = min_seq > doc.boundary ? min_seq : doc.boundary;
    }
    return r.ok;
}

struct Batch {
    std::vector<Doc> docs;
};

void fill(int32_t* row, int64_t n, int32_t v) {
    for (int64_t i = 0; i < n; ++i) row[i] = v;
}

}  // namespace

extern "C" {

// The routing verdict the pipeline takes before packing: 1 when the
// stream holds a revive, 2 a move of more than one id (whichever comes
// first), 0 neither, -1 a malformed stream.
int treepack_route(const uint8_t* buf, int64_t len) {
    Reader r{buf, len};
    std::vector<int32_t> ids;
    std::vector<Item> items;
    while (r.off < r.len) {
        r.skip(20);
        const int32_t n_edits = r.i32();
        r.skip(8);
        if (!r.ok || n_edits < 0) return -1;
        for (int32_t e = 0; e < n_edits; ++e) {
            switch (r.u8()) {
            case kInsert:
                r.skip(12);
                if (!read_items(r, items)) return -1;
                break;
            case kRemove:
                if (!read_ids(r, ids)) return -1;
                break;
            case kSet:
                r.skip(8);
                break;
            case kMove:
                r.skip(12);
                if (!read_ids(r, ids)) return -1;
                if (ids.size() != 1) return kFbMultiIdMove;
                break;
            case kRevive:
                return kFbRevive;
            default:
                return -1;
            }
            if (!r.ok) return -1;
        }
    }
    return r.ok ? 0 : -1;
}

// Parse and intern ``D`` streams.  ``val_map`` holds each document's
// doc-local -> batch-global value ids at ``val_offs[d]`` (``D + 1``
// offsets).  Writes per document, ``kMetaFields`` a row: n_nodes, n_cont,
// t_rows, header_seq, base_min_seq, boundary, fallback reason.  Returns
// the batch, or null with ``*bad_doc`` set to the malformed document.
void* treepack_begin(int32_t D, const uint8_t* const* blobs,
                     const int64_t* lens, const int32_t* val_map,
                     const int64_t* val_offs, int32_t* meta,
                     int32_t* bad_doc) {
    Batch* b = new Batch();
    b->docs.resize(D);
    for (int32_t d = 0; d < D; ++d) {
        Doc& doc = b->docs[d];
        if (!pack_doc(blobs[d], lens[d], val_map + val_offs[d],
                      val_offs[d + 1] - val_offs[d], doc)) {
            *bad_doc = d;
            delete b;
            return nullptr;
        }
        int32_t* m = meta + static_cast<int64_t>(d) * kMetaFields;
        m[0] = doc.n_nodes;
        m[1] = static_cast<int32_t>(doc.cont_node.size());
        m[2] = static_cast<int32_t>(doc.edits.size() / kEditFields);
        m[3] = doc.header_seq;
        m[4] = doc.base_min_seq;
        m[5] = doc.boundary;
        m[6] = doc.fallback;
    }
    return b;
}

// Each document's containers as (node, field) pairs, document after
// document, in interning order.
void treepack_containers(void* handle, int32_t* out) {
    const Batch* b = static_cast<const Batch*>(handle);
    int64_t k = 0;
    for (const Doc& doc : b->docs) {
        for (size_t c = 0; c < doc.cont_node.size(); ++c) {
            out[k++] = doc.cont_node[c];
            out[k++] = doc.cont_field[c];
        }
    }
}

// Fill every element of the planes (the Python pack's defaults, then its
// scatter in its order).  ``planes``: head, next, prev, node_container,
// container_parent, value, value_seq, insert_seq, removed_seq ([D, C] or
// [D, N]), then the 8 edit planes ([D, T]) in TreeEdits order.  Returns
// 0, or -1 - d when document d's rows overflow the buckets.
int treepack_finish(void* handle, int32_t N, int32_t C, int32_t T,
                    int32_t* const* planes) {
    const Batch* b = static_cast<const Batch*>(handle);
    int32_t *head = planes[0], *next = planes[1], *prev = planes[2],
            *node_cont = planes[3], *cont_parent = planes[4],
            *value = planes[5], *vseq = planes[6], *iseq = planes[7],
            *rseq = planes[8];
    const int32_t ed_default[kEditFields] = {0, 0, 0, kNil, 0, 0, kNoValue,
                                             -1};
    for (size_t d = 0; d < b->docs.size(); ++d) {
        const Doc& doc = b->docs[d];
        const int64_t rows = static_cast<int64_t>(doc.edits.size())
            / kEditFields;
        if (doc.n_nodes > N || static_cast<int64_t>(doc.cont_node.size()) > C
            || rows > T)
            return -1 - static_cast<int>(d);
        int32_t* h = head + d * C;
        int32_t* cp = cont_parent + d * C;
        int32_t* nx = next + d * N;
        int32_t* pv = prev + d * N;
        int32_t* nc = node_cont + d * N;
        int32_t* va = value + d * N;
        int32_t* vs = vseq + d * N;
        int32_t* is = iseq + d * N;
        int32_t* rs = rseq + d * N;
        fill(h, C, kNil);
        fill(cp, C, kNil);
        fill(nx, N, kNil);
        fill(pv, N, kNil);
        fill(nc, N, kNil);
        fill(va, N, kNoValue);
        fill(vs, N, 0);
        fill(is, N, 0);
        fill(rs, N, kNotRemoved);
        for (size_t c = 0; c < doc.cont_node.size(); ++c)
            cp[c] = doc.cont_node[c];
        for (size_t i = 0; i < doc.row_set.size(); ++i) {
            if (!doc.row_set[i]) continue;
            nc[i] = doc.row_cont[i];
            va[i] = doc.row_val[i];
            vs[i] = doc.row_vseq[i];
            is[i] = doc.row_iseq[i];
            rs[i] = doc.row_rseq[i];
        }
        for (size_t j = 0; j < doc.block_links.size(); j += 2) {
            nx[doc.block_links[j]] = doc.block_links[j + 1];
            pv[doc.block_links[j + 1]] = doc.block_links[j];
        }
        for (size_t k = 0; k < doc.chains.size(); ++k) {
            const std::vector<int32_t>& m = doc.chains[k];
            h[doc.chain_cont[k]] = m[0];
            for (size_t j = 1; j < m.size(); ++j) {
                nx[m[j - 1]] = m[j];
                pv[m[j]] = m[j - 1];
            }
        }
        for (int f = 0; f < kEditFields; ++f) {
            int32_t* ed = planes[9 + f] + d * T;
            for (int64_t t = 0; t < rows; ++t)
                ed[t] = doc.edits[t * kEditFields + f];
            fill(ed + rows, T - rows, ed_default[f]);
        }
    }
    return 0;
}

void treepack_free(void* handle) { delete static_cast<Batch*>(handle); }

}  // extern "C"
