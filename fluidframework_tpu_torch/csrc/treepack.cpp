// libtreepack — native pack of SharedTree edit records for the tree fold,
// and the canonical summary headers of the fold's final forest.
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
//   treepack_json_offsets(...) — where each element of a JSON array lies
//   treepack_split(...)      — where each string of a joined table lies
//   treepack_extract(...)    — final forest planes → canonical headers
//
// treepack_extract writes, per document, the exact bytes of
// canonical_json(root_obj) that tree_kernel.summary_from_state builds from
// the same planes: sorted keys, minimal separators, ensure_ascii=False
// (UTF-8 passes through; only '"', '\\' and control characters escape, as
// python json.dumps).  A document whose planes or tables hold anything
// that route would not turn into those bytes without an error (a chain
// cycle, a node in two chains, an index outside its plane, a nesting
// deeper than kMaxNest, a lone surrogate in an emitted string) gets a
// nonzero status and no bytes: the caller takes the Python route for it.

#include <algorithm>
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

// -- the summary writer -------------------------------------------------------

// The Python route nests two interpreter frames a forest level; a nesting
// this deep is far inside its recursion limit, and a deeper one is left to
// it (it may raise, and route the document to the oracle).
constexpr int kMaxNest = 128;

// Writer statuses: written, a cycle (a chain longer than the document's
// rows, or a node reached twice), anything else the Python route decides.
constexpr int32_t kWritten = 0, kCycle = 1, kPythonRoute = 2;

// A string table: piece i of ``blob`` is [offs[i], offs[i + 1] - 1) (the
// caller joins the strings with one byte between them).
struct Table {
    const uint8_t* blob;
    const int64_t* offs;
    const uint8_t* at(int64_t i) const { return blob + offs[i]; }
    int64_t len(int64_t i) const { return offs[i + 1] - 1 - offs[i]; }
};

struct Writer {
    uint8_t* out;
    int64_t cap;
    int64_t w = 0;  // keeps counting past the capacity
    bool lone = false;  // a lone surrogate (ED A0..BF ..) was written

    void put(const uint8_t* p, int64_t n) {
        if (w + n <= cap) std::memcpy(out + w, p, n);
        w += n;
    }
    void put_lit(const char* s) {
        put(reinterpret_cast<const uint8_t*>(s), std::strlen(s));
    }
    void put_ch(char c) {
        if (w < cap) out[w] = static_cast<uint8_t>(c);
        ++w;
    }
    void put_int(int64_t v) {
        char tmp[24];
        int n = 0;
        uint64_t u = v < 0 ? 0 - static_cast<uint64_t>(v)
                           : static_cast<uint64_t>(v);
        char digits[20];
        int nd = 0;
        do { digits[nd++] = static_cast<char>('0' + u % 10); u /= 10; }
        while (u > 0);
        if (v < 0) tmp[n++] = '-';
        while (nd > 0) tmp[n++] = digits[--nd];
        put(reinterpret_cast<const uint8_t*>(tmp), n);
    }
    // A JSON string as json.dumps(ensure_ascii=False) writes it.
    void put_str(const uint8_t* p, int64_t n) {
        put_ch('"');
        int64_t run = 0;
        for (int64_t i = 0; i < n; ++i) {
            const uint8_t ch = p[i];
            if (!(ch == '"' || ch == '\\' || ch < 0x20)) {
                if (ch == 0xED && i + 1 < n && p[i + 1] >= 0xA0) lone = true;
                ++run;
                continue;
            }
            if (run) put(p + i - run, run);
            run = 0;
            switch (ch) {
                case '"': put_lit("\\\""); break;
                case '\\': put_lit("\\\\"); break;
                case '\b': put_lit("\\b"); break;
                case '\t': put_lit("\\t"); break;
                case '\n': put_lit("\\n"); break;
                case '\f': put_lit("\\f"); break;
                case '\r': put_lit("\\r"); break;
                default: {
                    static const char* hex = "0123456789abcdef";
                    const char u[6] = {'\\', 'u', '0', '0', hex[ch >> 4],
                                       hex[ch & 0xF]};
                    put(reinterpret_cast<const uint8_t*>(u), 6);
                }
            }
        }
        if (run) put(p + n - run, run);
        put_ch('"');
    }
};

// One document's planes, tables and scratch for the writer.
struct DocView {
    const int32_t *head, *next, *removed, *ins, *val, *vseq, *cparent;
    int32_t N, C, n, nc;
    int64_t msn;
    const int32_t* owner;       // [nc] each container's owning node
    Table ids, types, fields;
    int64_t id0, field0;        // this document's first piece
    const uint8_t* vals;
    const int64_t* val_offs;
    int32_t n_vals;

    // scratch, reused across documents
    std::vector<int32_t> chain_start, chain_len, chain_nodes, kept;
    std::vector<int32_t> by_owner, owner_start, fill_at;
    std::vector<uint8_t> in_chain, emitted;
    std::vector<int32_t> limbo;
    int64_t emitted_nodes = 0;

    bool keep(int32_t i) const {
        const int32_t rs = removed[i];
        return !(rs != kNotRemoved && rs <= msn);
    }
    // Byte order of two pieces, which is the code-point order of the
    // strings; -1, 0 or 1.
    static int compare(const Table& t, int64_t a, int64_t b) {
        const int64_t la = t.len(a), lb = t.len(b);
        const int c = std::memcmp(t.at(a), t.at(b),
                                  static_cast<size_t>(std::min(la, lb)));
        if (c != 0) return c < 0 ? -1 : 1;
        return la < lb ? -1 : (la > lb ? 1 : 0);
    }
    bool field_less(int32_t a, int32_t b) const {
        const int c = compare(fields, field0 + a, field0 + b);
        return c != 0 ? c < 0 : a < b;
    }
    bool id_less(int32_t a, int32_t b) const {
        return compare(ids, id0 + a, id0 + b) < 0;
    }

    // Walk every container's chain once; each node may lie in one chain.
    int32_t walk_chains() {
        chain_start.assign(nc, 0);
        chain_len.assign(nc, 0);
        kept.assign(nc, 0);
        chain_nodes.clear();
        in_chain.assign(N, 0);
        for (int32_t c = 0; c < nc; ++c) {
            chain_start[c] = static_cast<int32_t>(chain_nodes.size());
            int32_t cur = head[c];
            int32_t len = 0;
            while (cur != kNil) {
                if (cur < 0 || cur >= N) return kPythonRoute;
                if (len >= n) return kCycle;
                if (in_chain[cur]) return kCycle;
                in_chain[cur] = 1;
                chain_nodes.push_back(cur);
                kept[c] += keep(cur);
                ++len;
                cur = next[cur];
            }
            chain_len[c] = len;
        }
        return kWritten;
    }

    // Containers by owning node (owners in [0, n)), each owner's sorted by
    // field name: code-point order is UTF-8 byte order.
    void group_containers() {
        owner_start.assign(static_cast<size_t>(n) + 1, 0);
        for (int32_t c = 0; c < nc; ++c)
            if (owner[c] >= 0 && owner[c] < n) ++owner_start[owner[c] + 1];
        for (int32_t i = 0; i < n; ++i) owner_start[i + 1] += owner_start[i];
        by_owner.assign(owner_start[n], 0);
        fill_at.assign(owner_start.begin(), owner_start.end() - 1);
        for (int32_t c = 0; c < nc; ++c)
            if (owner[c] >= 0 && owner[c] < n)
                by_owner[fill_at[owner[c]]++] = c;
        for (int32_t i = 0; i < n; ++i) {
            if (owner_start[i + 1] - owner_start[i] > 1)
                std::sort(by_owner.begin() + owner_start[i],
                          by_owner.begin() + owner_start[i + 1],
                          [this](int32_t a, int32_t b) {
                              return field_less(a, b);
                          });
        }
    }

    // The fields object of node ``i`` (assumed to hold a kept kid).
    int32_t fields_of(Writer& wr, int32_t i, int depth) {
        wr.put_ch('{');
        bool first = true;
        if (i < n) {
            for (int32_t k = owner_start[i]; k < owner_start[i + 1]; ++k) {
                const int32_t c = by_owner[k];
                if (!kept[c]) continue;
                if (!first) wr.put_ch(',');
                first = false;
                wr.put_str(fields.at(field0 + c), fields.len(field0 + c));
                wr.put_lit(":[");
                bool kid0 = true;
                for (int32_t j = 0; j < chain_len[c]; ++j) {
                    const int32_t kid = chain_nodes[chain_start[c] + j];
                    if (!keep(kid)) continue;
                    if (!kid0) wr.put_ch(',');
                    kid0 = false;
                    const int32_t st = node(wr, kid, depth + 1);
                    if (st != kWritten) return st;
                }
                wr.put_ch(']');
            }
        }
        wr.put_ch('}');
        return kWritten;
    }

    bool has_fields(int32_t i) const {
        if (i >= n) return false;
        for (int32_t k = owner_start[i]; k < owner_start[i + 1]; ++k)
            if (kept[by_owner[k]]) return true;
        return false;
    }

    int32_t node(Writer& wr, int32_t i, int depth) {
        if (i >= n) return kPythonRoute;
        if (emitted[i]) return kCycle;
        if (depth > kMaxNest) return kPythonRoute;
        emitted[i] = 1;
        ++emitted_nodes;
        wr.put_ch('{');
        if (has_fields(i)) {
            wr.put_lit("\"fields\":");
            const int32_t st = fields_of(wr, i, depth);
            if (st != kWritten) return st;
            wr.put_ch(',');
        }
        wr.put_lit("\"id\":");
        wr.put_str(ids.at(id0 + i), ids.len(id0 + i));
        const int32_t is = ins[i];
        wr.put_lit(",\"insertSeq\":");
        wr.put_int(is <= msn ? 0 : is);
        const int32_t rs = removed[i];
        if (rs != kNotRemoved) {
            wr.put_lit(",\"removedSeq\":");
            wr.put_int(rs);
        }
        wr.put_lit(",\"type\":");
        wr.put_str(types.at(id0 + i), types.len(id0 + i));
        const int32_t v = val[i];
        if (v != kNoValue) {
            if (v < 0 || v >= n_vals) return kPythonRoute;
            wr.put_lit(",\"value\":");
            wr.put(vals + val_offs[v], val_offs[v + 1] - 1 - val_offs[v]);
            const int32_t vs = vseq[i];
            wr.put_lit(",\"valueSeq\":");
            wr.put_int(vs <= msn ? 0 : vs);
        }
        wr.put_ch('}');
        return kWritten;
    }

    int32_t write(Writer& wr, int64_t seq) {
        if (n <= 0 || n > N || nc < 0 || nc > C) return kPythonRoute;
        int32_t st = walk_chains();
        if (st != kWritten) return st;
        group_containers();
        emitted.assign(n, 0);
        emitted_nodes = 0;
        wr.put_lit("{\"fields\":");
        st = fields_of(wr, 0, 0);
        if (st != kWritten) return st;
        // Limbo: kept nodes linked under an owner that is not kept.
        limbo.clear();
        for (int32_t c = 0; c < nc; ++c) {
            const int32_t o = cparent[c];
            if (o == kNil) continue;
            if (o < 0 || o >= N) return kPythonRoute;
            if (keep(o)) continue;
            for (int32_t j = 0; j < chain_len[c]; ++j) {
                const int32_t i = chain_nodes[chain_start[c] + j];
                if (keep(i)) limbo.push_back(i);
            }
        }
        if (!limbo.empty()) {
            for (int32_t i : limbo)
                if (i >= n) return kPythonRoute;
            std::stable_sort(limbo.begin(), limbo.end(),
                             [this](int32_t a, int32_t b) {
                                 return id_less(a, b);
                             });
            wr.put_lit(",\"limbo\":[");
            for (size_t k = 0; k < limbo.size(); ++k) {
                if (k) wr.put_ch(',');
                st = node(wr, limbo[k], 1);
                if (st != kWritten) return st;
            }
            wr.put_ch(']');
        }
        wr.put_lit(",\"minSeq\":");
        wr.put_int(msn);
        wr.put_lit(",\"seq\":");
        wr.put_int(seq);
        wr.put_ch('}');
        return wr.lone ? kPythonRoute : kWritten;
    }
};

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

// Where each of the ``n`` elements of the JSON array text ``blob`` (as
// canonical_json writes a list: no whitespace) lies: element i is
// [offs[i], offs[i + 1] - 1).  Returns 0, or -1 when the text does not
// hold ``n`` elements.
int treepack_json_offsets(const uint8_t* blob, int64_t len, int32_t n,
                          int64_t* offs) {
    if (len < 2 || blob[0] != '[' || blob[len - 1] != ']') return -1;
    if (n == 0) {
        offs[0] = len;
        return len == 2 ? 0 : -1;
    }
    int32_t k = 0;
    offs[k++] = 1;
    int depth = 0;
    bool in_str = false;
    for (int64_t i = 1; i < len - 1; ++i) {
        const uint8_t ch = blob[i];
        if (in_str) {
            if (ch == '\\') ++i;
            else if (ch == '"') in_str = false;
            continue;
        }
        if (ch == '"') in_str = true;
        else if (ch == '[' || ch == '{') ++depth;
        else if (ch == ']' || ch == '}') --depth;
        else if (ch == ',' && depth == 0) {
            if (k >= n) return -1;
            offs[k++] = i + 1;
        }
    }
    if (k != n || depth != 0 || in_str) return -1;
    offs[n] = len;
    return 0;
}

// Where the ``want`` strings of a table joined with NUL bytes lie: piece i
// is [offs[i], offs[i + 1] - 1).  Returns 0, or -1 when ``blob`` holds
// another number of pieces (a string holds a NUL: the caller measures the
// strings itself).
int treepack_split(const uint8_t* blob, int64_t len, int64_t want,
                   int64_t* offs) {
    if (want == 0) {
        offs[0] = len + 1;
        return len == 0 ? 0 : -1;
    }
    int64_t k = 0;
    offs[k++] = 0;
    const uint8_t* end = blob + len;
    for (const uint8_t* q = blob;
         (q = static_cast<const uint8_t*>(
              std::memchr(q, 0, static_cast<size_t>(end - q))));
         ++q) {
        if (k >= want) return -1;
        offs[k++] = (q - blob) + 1;
    }
    if (k != want) return -1;
    offs[want] = len + 1;
    return 0;
}

// Canonical headers of ``D`` documents from their final forest planes.
// ``rows[k]`` is document k's row in the planes; ``planes``: head, next,
// removed_seq, insert_seq, value, value_seq, container_parent, each with
// its row stride in ``strides`` (elements); widths N (node planes) and C.
// Per document: ``msn`` (the larger of final_msn and the base's minSeq),
// ``seq`` (the header's), ``n_nodes`` interned rows, ``n_cont``
// containers and their owners (``cont_owner``, document after document).
// The id and type tables hold ``n_nodes[k]`` strings a document, the field
// table ``n_cont[k]``, each with its treepack_split offsets; ``vals`` is
// the value table's canonical JSON array, ``val_offs`` from
// treepack_json_offsets.  Writes document k's bytes at
// [out_offs[k], out_offs[k + 1]), its emitted nodes and its status.
// Returns 0, or, when ``cap`` is too small, -(bytes needed) - 2.
int64_t treepack_extract(
    int32_t D, const int32_t* rows, const int32_t* const* planes,
    const int64_t* strides, int32_t N, int32_t C,
    const int64_t* msn, const int64_t* seq,
    const int32_t* n_nodes, const int32_t* n_cont, const int32_t* cont_owner,
    const uint8_t* ids, const int64_t* id_offs,
    const uint8_t* types, const int64_t* type_offs,
    const uint8_t* fields, const int64_t* field_offs,
    const uint8_t* vals, const int64_t* val_offs, int32_t n_vals,
    uint8_t* out, int64_t cap, int64_t* out_offs, int64_t* out_nodes,
    int32_t* status) {
    Writer wr{out, cap};
    DocView v;
    v.N = N;
    v.C = C;
    v.ids = Table{ids, id_offs};
    v.types = Table{types, type_offs};
    v.fields = Table{fields, field_offs};
    v.vals = vals;
    v.val_offs = val_offs;
    v.n_vals = n_vals;
    int64_t id0 = 0, field0 = 0;
    for (int32_t k = 0; k < D; ++k) {
        const int64_t r = rows[k];
        v.head = planes[0] + r * strides[0];
        v.next = planes[1] + r * strides[1];
        v.removed = planes[2] + r * strides[2];
        v.ins = planes[3] + r * strides[3];
        v.val = planes[4] + r * strides[4];
        v.vseq = planes[5] + r * strides[5];
        v.cparent = planes[6] + r * strides[6];
        v.n = n_nodes[k];
        v.nc = n_cont[k];
        v.msn = msn[k];
        v.owner = cont_owner + field0;
        v.id0 = id0;
        v.field0 = field0;
        const int64_t start = wr.w;
        out_offs[k] = start;
        wr.lone = false;
        status[k] = v.write(wr, seq[k]);
        out_nodes[k] = status[k] == kWritten ? v.emitted_nodes : 0;
        if (status[k] != kWritten) wr.w = start;
        id0 += n_nodes[k];
        field0 += n_cont[k];
    }
    out_offs[D] = wr.w;
    return wr.w <= cap ? 0 : -(wr.w) - 2;
}

}  // extern "C"
