/* fastpack: the packed buffers of a whole batch in one pass on the host
 * (the native path of `data/packing.py`'s `pack_samples`; the same
 * semantics as its numpy `_assemble`, held equal byte for byte by the
 * tests).
 *
 * A plain C interface, loaded with ctypes (`ops/_build.py` compiles it with
 * the host C++ compiler). The batch arrives as flat arrays that
 * `packing._flatten` builds from the packer's descriptors:
 *
 *   items   int64 [n_items, 5]: (kind, n_ids, modality type, interior, eom)
 *           per item, sample after sample. kind 0: text, its n_ids ids
 *           cfg-maskable. kind 1: a modality, its n_ids head ids (meta
 *           frame, may be none), `interior` positions left at -1 and
 *           recorded as a span, then `eom` when eom >= 0.
 *   counts  int64 [b]: the items of each sample
 *   ids     int32: every item's ids, in item order
 *
 * Outputs, written whole here: text int32 [b, n_pad] (-1 at modality
 * interiors and padding), cfg uint8 [b, n_pad] (numpy bool), spans int32
 * [b, m_pad, 3] (type, offset, length; zero past a sample's modalities),
 * lengths int32 [b].
 *
 * Returns 0; 1 when a sample does not fit n_pad positions; 2 when it has
 * more than m_pad modalities; 3 when an item's kind is neither.
 */

#include <cstdint>
#include <cstring>

extern "C" int fastpack(int64_t b, int64_t n_pad, int64_t m_pad, const int64_t *items,
                        const int64_t *counts, const int32_t *ids, int32_t *text,
                        uint8_t *cfg, int32_t *spans, int32_t *lengths) {
  for (int64_t i = 0; i < b * n_pad; i++) text[i] = -1;
  std::memset(cfg, 0, static_cast<size_t>(b * n_pad));
  std::memset(spans, 0, static_cast<size_t>(b * m_pad * 3) * sizeof(int32_t));

  const int64_t *item = items;
  const int32_t *src = ids;
  for (int64_t s = 0; s < b; s++) {
    int32_t *trow = text + s * n_pad;
    uint8_t *crow = cfg + s * n_pad;
    int32_t *srow = spans + s * m_pad * 3;
    int64_t off = 0, span = 0;
    for (int64_t k = 0; k < counts[s]; k++, item += 5) {
      const int64_t kind = item[0], n_ids = item[1];
      if (kind == 0) {
        if (off + n_ids > n_pad) return 1;
        std::memcpy(trow + off, src, static_cast<size_t>(n_ids) * sizeof(int32_t));
        std::memset(crow + off, 1, static_cast<size_t>(n_ids));
        off += n_ids;
      } else if (kind == 1) {
        const int64_t interior = item[3], eom = item[4];
        if (off + n_ids + interior + (eom >= 0 ? 1 : 0) > n_pad) return 1;
        if (span >= m_pad) return 2;
        std::memcpy(trow + off, src, static_cast<size_t>(n_ids) * sizeof(int32_t));
        srow[span * 3 + 0] = static_cast<int32_t>(item[2]);
        srow[span * 3 + 1] = static_cast<int32_t>(off + n_ids);
        srow[span * 3 + 2] = static_cast<int32_t>(interior);
        span++;
        off += n_ids + interior;
        if (eom >= 0) trow[off++] = static_cast<int32_t>(eom);
      } else {
        return 3;
      }
      src += n_ids;
    }
    lengths[s] = static_cast<int32_t>(off);
  }
  return 0;
}
