// Native GSD (General Simulation Data) v1/v2 trajectory I/O of the
// PyTorch package (hoomd_tf_tpu_torch.utils.gsd_io), a host library: no
// kernel, built with g++ (_build.build_host_library), not nvcc.
//
// The package reads and writes trajectories without the `gsd` Python
// package or MDAnalysis: a chunk is parsed here and copied once into a
// numpy array. Exposed through a C ABI consumed via ctypes; the file
// format and the C functions are those of the JAX package's loader, so a
// file written by either package is read by the other.
//
// File layout (GSD spec, validated against hoomd-written files):
//   header (256 B): magic, index_location, index_allocated_entries,
//                   namelist_location, namelist_allocated_entries,
//                   schema_version, gsd_version, application[64],
//                   schema[64], reserved[80]
//   index: array of 32 B entries {frame u64, N u64, location i64, M u32,
//                                 id u16, type u8, flags u8}
//   namelist: v1 = 64 B fixed records; v2 = packed \0-terminated names
//   data chunks at arbitrary offsets.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x65DF65DF65DF65DFull;

#pragma pack(push, 1)
struct Header {
    uint64_t magic;
    uint64_t index_location;
    uint64_t index_allocated_entries;
    uint64_t namelist_location;
    uint64_t namelist_allocated_entries;
    uint32_t schema_version;
    uint32_t gsd_version;
    char application[64];
    char schema[64];
    char reserved[80];
};
struct IndexEntry {
    uint64_t frame;
    uint64_t N;
    int64_t location;
    uint32_t M;
    uint16_t id;
    uint8_t type;
    uint8_t flags;
};
#pragma pack(pop)

static_assert(sizeof(Header) == 256, "header must be 256 bytes");
static_assert(sizeof(IndexEntry) == 32, "index entry must be 32 bytes");

size_t type_size(uint8_t t) {
    switch (t) {
        case 1: case 5: return 1;   // uint8 / int8
        case 2: case 6: return 2;   // uint16 / int16
        case 3: case 7: return 4;   // uint32 / int32
        case 4: case 8: return 8;   // uint64 / int64
        case 9: return 4;           // float
        case 10: return 8;          // double
        default: return 0;
    }
}

struct File {
    FILE* fp = nullptr;
    Header header{};
    std::vector<IndexEntry> index;       // valid entries only, sorted
    std::vector<std::string> names;      // id -> name
    uint64_t nframes = 0;
    bool writing = false;
    // writer state
    std::vector<IndexEntry> windex;
    std::vector<std::string> wnames;
    std::string wdata;
    uint64_t wframe = 0;

    int name_id(const std::string& n, bool create) {
        auto& list = writing ? wnames : names;
        for (size_t i = 0; i < list.size(); ++i)
            if (list[i] == n) return (int)i;
        if (!create) return -1;
        list.push_back(n);
        return (int)list.size() - 1;
    }
};

bool load_names(File* f) {
    const Header& h = f->header;
    uint64_t gsd_major = h.gsd_version >> 16;
    if (fseek(f->fp, (long)h.namelist_location, SEEK_SET) != 0) return false;
    if (gsd_major >= 2) {
        // v2: packed \0-terminated names in namelist_allocated_entries *
        // 64-byte pages
        std::string buf(h.namelist_allocated_entries * 64, '\0');
        if (fread(&buf[0], 1, buf.size(), f->fp) != buf.size()) return false;
        size_t pos = 0;
        while (pos < buf.size() && buf[pos] != '\0') {
            std::string n(buf.c_str() + pos);
            f->names.push_back(n);
            pos += n.size() + 1;
        }
    } else {
        // v1: fixed 64-byte records
        for (uint64_t i = 0; i < h.namelist_allocated_entries; ++i) {
            char rec[64];
            if (fread(rec, 1, 64, f->fp) != 64) return false;
            if (rec[0] == '\0') break;
            f->names.emplace_back(rec, strnlen(rec, 64));
        }
    }
    return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// reading
// ---------------------------------------------------------------------------

void* htf_gsd_open(const char* path) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return nullptr;
    File* f = new File();
    f->fp = fp;
    if (fread(&f->header, sizeof(Header), 1, fp) != 1 ||
        f->header.magic != kMagic) {
        fclose(fp);
        delete f;
        return nullptr;
    }
    const Header& h = f->header;
    if (fseek(fp, (long)h.index_location, SEEK_SET) != 0) {
        fclose(fp); delete f; return nullptr;
    }
    std::vector<IndexEntry> raw(h.index_allocated_entries);
    size_t got = fread(raw.data(), sizeof(IndexEntry), raw.size(), fp);
    raw.resize(got);
    for (const auto& e : raw) {
        if (e.location == 0) break;  // unused tail
        f->index.push_back(e);
        if (e.frame + 1 > f->nframes) f->nframes = e.frame + 1;
    }
    if (!load_names(f)) { fclose(fp); delete f; return nullptr; }
    return f;
}

uint64_t htf_gsd_nframes(void* handle) {
    return ((File*)handle)->nframes;
}

const char* htf_gsd_schema(void* handle) {
    return ((File*)handle)->header.schema;
}

// Find the chunk (frame, name), with GSD's fall-back-to-frame-0 semantics.
// Returns 1 and fills N/M/type on success, 0 if the chunk doesn't exist.
int htf_gsd_chunk_info(void* handle, uint64_t frame, const char* name,
                       uint64_t* N, uint32_t* M, uint8_t* type) {
    File* f = (File*)handle;
    int id = f->name_id(name, false);
    if (id < 0) return 0;
    const IndexEntry* best = nullptr;
    for (const auto& e : f->index) {
        if (e.id != (uint16_t)id) continue;
        if (e.frame == frame) { best = &e; break; }
        if (e.frame == 0) best = &e;  // fallback candidate
    }
    if (!best) return 0;
    *N = best->N;
    *M = best->M;
    *type = best->type;
    return 1;
}

// Read chunk data into out (caller allocates N*M*type_size bytes).
int htf_gsd_read_chunk(void* handle, uint64_t frame, const char* name,
                       void* out) {
    File* f = (File*)handle;
    int id = f->name_id(name, false);
    if (id < 0) return 0;
    const IndexEntry* best = nullptr;
    for (const auto& e : f->index) {
        if (e.id != (uint16_t)id) continue;
        if (e.frame == frame) { best = &e; break; }
        if (e.frame == 0) best = &e;
    }
    if (!best) return 0;
    size_t bytes = best->N * best->M * type_size(best->type);
    if (fseek(f->fp, (long)best->location, SEEK_SET) != 0) return 0;
    return fread(out, 1, bytes, f->fp) == bytes ? 1 : 0;
}

// ---------------------------------------------------------------------------
// writing (buffered; file materialized on close)
// ---------------------------------------------------------------------------

void* htf_gsd_create(const char* path, const char* application,
                     const char* schema, uint32_t schema_version) {
    FILE* fp = fopen(path, "wb");
    if (!fp) return nullptr;
    File* f = new File();
    f->fp = fp;
    f->writing = true;
    memset(&f->header, 0, sizeof(Header));
    f->header.magic = kMagic;
    f->header.schema_version = schema_version;
    f->header.gsd_version = 0x00010000;  // write v1 layout (widely readable)
    snprintf(f->header.application, 64, "%s", application);
    snprintf(f->header.schema, 64, "%s", schema);
    return f;
}

int htf_gsd_write_chunk(void* handle, const char* name, uint8_t type,
                        uint64_t N, uint32_t M, const void* data) {
    File* f = (File*)handle;
    if (!f->writing) return 0;
    int id = f->name_id(name, true);
    if (id > 0xFFFF) return 0;
    IndexEntry e{};
    e.frame = f->wframe;
    e.N = N;
    e.M = M;
    e.id = (uint16_t)id;
    e.type = type;
    e.location = (int64_t)f->wdata.size();  // relative; fixed on close
    f->windex.push_back(e);
    f->wdata.append((const char*)data, N * M * type_size(type));
    // pad to 8-byte alignment like upstream gsd
    while (f->wdata.size() % 8) f->wdata.push_back('\0');
    return 1;
}

int htf_gsd_end_frame(void* handle) {
    File* f = (File*)handle;
    if (!f->writing) return 0;
    f->wframe += 1;
    return 1;
}

int htf_gsd_close(void* handle) {
    File* f = (File*)handle;
    int ok = 1;
    if (f->writing) {
        // layout: header | index | namelist | data
        uint64_t index_entries = f->windex.size();
        // allocate power-of-two-ish table like upstream (min 128)
        uint64_t index_alloc = 128;
        while (index_alloc < index_entries) index_alloc *= 2;
        uint64_t name_alloc = 128;
        while (name_alloc < f->wnames.size()) name_alloc *= 2;
        uint64_t index_loc = sizeof(Header);
        uint64_t name_loc = index_loc + index_alloc * sizeof(IndexEntry);
        uint64_t data_loc = name_loc + name_alloc * 64;

        f->header.index_location = index_loc;
        f->header.index_allocated_entries = index_alloc;
        f->header.namelist_location = name_loc;
        f->header.namelist_allocated_entries = name_alloc;

        for (auto& e : f->windex) e.location += (int64_t)data_loc;

        ok &= fwrite(&f->header, sizeof(Header), 1, f->fp) == 1;
        ok &= fwrite(f->windex.data(), sizeof(IndexEntry), index_entries,
                     f->fp) == index_entries;
        std::string zeros((index_alloc - index_entries) * sizeof(IndexEntry),
                          '\0');
        ok &= fwrite(zeros.data(), 1, zeros.size(), f->fp) == zeros.size();
        for (const auto& n : f->wnames) {
            char rec[64] = {0};
            snprintf(rec, 64, "%s", n.c_str());
            ok &= fwrite(rec, 1, 64, f->fp) == 64;
        }
        std::string nz((name_alloc - f->wnames.size()) * 64, '\0');
        ok &= fwrite(nz.data(), 1, nz.size(), f->fp) == nz.size();
        ok &= fwrite(f->wdata.data(), 1, f->wdata.size(), f->fp) ==
              f->wdata.size();
    }
    fclose(f->fp);
    delete f;
    return ok;
}

}  // extern "C"
