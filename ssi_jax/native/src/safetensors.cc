// First-party C++ safetensors reader/writer (mmap, zero-copy reads).
//
// Replaces the reference's native safetensors Rust crate (the reference loads
// and saves HF checkpoints through safetensors.torch — ref: ssi/checkpoint.py)
// with a first-party implementation exposed to Python over a C ABI (ctypes).
//
// Format (https spec, reproduced from first principles):
//   [u64 little-endian header_len][header JSON, UTF-8][raw tensor bytes]
// header: {"__metadata__"?: {str: str}, <name>: {"dtype": str,
//          "shape": [int...], "data_offsets": [begin, end]}, ...}
// data_offsets are relative to the end of the header. The official writer pads
// the header with trailing spaces to an 8-byte boundary so tensor data is
// aligned; we do the same.
//
// Reads are zero-copy: st_tensor_info returns a pointer into the mmap'd file;
// the Python wrapper wraps it in a NumPy array that keeps the handle alive.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (see ssi_jax/native/__init__.py).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "json_mini.h"

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

struct TensorInfo {
  std::string name;
  std::string dtype;
  std::vector<int64_t> shape;
  int64_t begin = 0;  // relative to data section
  int64_t end = 0;
};

int64_t dtype_itemsize(const std::string& dt) {
  if (dt == "F64" || dt == "I64" || dt == "U64") return 8;
  if (dt == "F32" || dt == "I32" || dt == "U32") return 4;
  if (dt == "F16" || dt == "BF16" || dt == "I16" || dt == "U16") return 2;
  if (dt == "I8" || dt == "U8" || dt == "BOOL" || dt == "F8_E4M3" || dt == "F8_E5M2") return 1;
  return -1;
}

struct StFile {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t file_size = 0;
  size_t data_start = 0;  // offset of the data section in the file
  std::vector<TensorInfo> tensors;
  std::unordered_map<std::string, size_t> by_name;
  std::string metadata_json;  // "{}"-style serialization of __metadata__, or empty

  ~StFile() {
    if (map) munmap(const_cast<uint8_t*>(map), file_size);
    if (fd >= 0) close(fd);
  }
};

void serialize_value(std::string& out, const jsonmini::Value& v) {
  using K = jsonmini::Value::Kind;
  switch (v.kind) {
    case K::Null: out += "null"; break;
    case K::Bool: out += v.b ? "true" : "false"; break;
    case K::Int: out += std::to_string(v.i); break;
    case K::Double: {
      char buf[32];
      snprintf(buf, sizeof(buf), "%.17g", v.d);
      out += buf;
      break;
    }
    case K::Str: jsonmini::write_escaped(out, v.s); break;
    case K::Arr:
      out += '[';
      for (size_t i = 0; i < v.arr.size(); ++i) {
        if (i) out += ',';
        serialize_value(out, *v.arr[i]);
      }
      out += ']';
      break;
    case K::Obj:
      out += '{';
      for (size_t i = 0; i < v.obj.size(); ++i) {
        if (i) out += ',';
        jsonmini::write_escaped(out, v.obj[i].first);
        out += ':';
        serialize_value(out, *v.obj[i].second);
      }
      out += '}';
      break;
  }
}

}  // namespace

extern "C" {

const char* st_last_error() { return g_last_error.c_str(); }

void* st_open(const char* path) {
  auto f = std::make_unique<StFile>();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) {
    set_error(std::string("cannot open ") + path);
    return nullptr;
  }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size < 8) {
    set_error("file too small for safetensors header");
    return nullptr;
  }
  f->file_size = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, f->file_size, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (m == MAP_FAILED) {
    set_error("mmap failed");
    return nullptr;
  }
  f->map = static_cast<const uint8_t*>(m);

  uint64_t header_len;
  std::memcpy(&header_len, f->map, 8);  // little-endian host assumed (x86/ARM LE)
  if (header_len > f->file_size - 8) {
    set_error("header length exceeds file size");
    return nullptr;
  }
  f->data_start = 8 + header_len;
  const int64_t data_size = static_cast<int64_t>(f->file_size - f->data_start);

  jsonmini::ValuePtr root;
  try {
    root = jsonmini::parse(reinterpret_cast<const char*>(f->map + 8), header_len);
  } catch (const std::exception& e) {
    set_error(std::string("header parse error: ") + e.what());
    return nullptr;
  }
  if (root->kind != jsonmini::Value::Kind::Obj) {
    set_error("header is not a JSON object");
    return nullptr;
  }

  for (const auto& [key, val] : root->obj) {
    if (key == "__metadata__") {
      std::string out;
      serialize_value(out, *val);
      f->metadata_json = std::move(out);
      continue;
    }
    if (val->kind != jsonmini::Value::Kind::Obj) {
      set_error("tensor entry is not an object: " + key);
      return nullptr;
    }
    TensorInfo t;
    t.name = key;
    const auto* dt = val->find("dtype");
    const auto* sh = val->find("shape");
    const auto* off = val->find("data_offsets");
    if (!dt || !sh || !off || (*dt)->kind != jsonmini::Value::Kind::Str ||
        (*sh)->kind != jsonmini::Value::Kind::Arr || (*off)->kind != jsonmini::Value::Kind::Arr ||
        (*off)->arr.size() != 2) {
      set_error("malformed tensor entry: " + key);
      return nullptr;
    }
    t.dtype = (*dt)->s;
    const int64_t itemsize = dtype_itemsize(t.dtype);
    if (itemsize < 0) {
      set_error("unknown dtype " + t.dtype + " for tensor " + key);
      return nullptr;
    }
    int64_t numel = 1;
    for (const auto& dim : (*sh)->arr) {
      if (dim->kind != jsonmini::Value::Kind::Int || dim->i < 0) {
        set_error("bad shape for tensor " + key);
        return nullptr;
      }
      t.shape.push_back(dim->i);
      if (dim->i > 0 && numel > INT64_MAX / itemsize / dim->i) {
        set_error("tensor size overflows int64: " + key);
        return nullptr;
      }
      numel *= dim->i;
    }
    t.begin = (*off)->arr[0]->i;
    t.end = (*off)->arr[1]->i;
    if (t.begin < 0 || t.end < t.begin || t.end > data_size) {
      set_error("data_offsets out of bounds for tensor " + key);
      return nullptr;
    }
    if (t.end - t.begin != numel * itemsize) {
      set_error("data_offsets size mismatch for tensor " + key);
      return nullptr;
    }
    if (f->by_name.count(t.name)) {
      set_error("duplicate tensor name in header: " + key);
      return nullptr;
    }
    f->by_name[t.name] = f->tensors.size();
    f->tensors.push_back(std::move(t));
  }
  return f.release();
}

void st_close(void* handle) { delete static_cast<StFile*>(handle); }

int64_t st_n_tensors(void* handle) {
  return static_cast<int64_t>(static_cast<StFile*>(handle)->tensors.size());
}

const char* st_tensor_name(void* handle, int64_t i) {
  auto* f = static_cast<StFile*>(handle);
  if (i < 0 || i >= static_cast<int64_t>(f->tensors.size())) return nullptr;
  return f->tensors[static_cast<size_t>(i)].name.c_str();
}

const char* st_metadata_json(void* handle) {
  auto* f = static_cast<StFile*>(handle);
  return f->metadata_json.empty() ? nullptr : f->metadata_json.c_str();
}

// Fills dtype (caller buffer >= 16 bytes), shape (caller buffer of length
// max_ndim), ndim, and a zero-copy pointer + byte length into the mmap.
int st_tensor_info(void* handle, const char* name, char* dtype_out, int64_t* ndim,
                   int64_t* shape_out, int64_t max_ndim, const uint8_t** data,
                   int64_t* nbytes) {
  auto* f = static_cast<StFile*>(handle);
  auto it = f->by_name.find(name);
  if (it == f->by_name.end()) {
    set_error(std::string("no tensor named ") + name);
    return -1;
  }
  const TensorInfo& t = f->tensors[it->second];
  if (static_cast<int64_t>(t.shape.size()) > max_ndim) {
    set_error("rank exceeds caller buffer");
    return -1;
  }
  snprintf(dtype_out, 16, "%s", t.dtype.c_str());
  *ndim = static_cast<int64_t>(t.shape.size());
  for (size_t k = 0; k < t.shape.size(); ++k) shape_out[k] = t.shape[k];
  *data = f->map + f->data_start + t.begin;
  *nbytes = t.end - t.begin;
  return 0;
}

// One-shot writer. shapes_flat holds the concatenation of all shapes, indexed
// via ndims. metadata_json, if non-null, must serialize a {str: str} object and
// is embedded verbatim as __metadata__. Tensors are laid out in argument order.
int st_save(const char* path, int64_t n, const char** names, const char** dtypes,
            const int64_t* ndims, const int64_t* shapes_flat, const uint8_t** datas,
            const int64_t* nbytes, const char* metadata_json) {
  std::string header = "{";
  bool first = true;
  if (metadata_json != nullptr) {
    header += "\"__metadata__\":";
    header += metadata_json;
    first = false;
  }
  int64_t offset = 0;
  size_t shape_pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (dtype_itemsize(dtypes[i]) < 0) {
      set_error(std::string("unknown dtype ") + dtypes[i]);
      return -1;
    }
    if (!first) header += ',';
    first = false;
    jsonmini::write_escaped(header, names[i]);
    header += ":{\"dtype\":\"";
    header += dtypes[i];
    header += "\",\"shape\":[";
    for (int64_t k = 0; k < ndims[i]; ++k) {
      if (k) header += ',';
      header += std::to_string(shapes_flat[shape_pos + k]);
    }
    shape_pos += static_cast<size_t>(ndims[i]);
    header += "],\"data_offsets\":[";
    header += std::to_string(offset);
    header += ',';
    header += std::to_string(offset + nbytes[i]);
    header += "]}";
    offset += nbytes[i];
  }
  header += '}';
  // Pad with spaces to an 8-byte boundary (matches the official writer, keeps
  // tensor data aligned for zero-copy readers).
  while ((8 + header.size()) % 8 != 0) header += ' ';

  FILE* out = fopen(path, "wb");
  if (!out) {
    set_error(std::string("cannot open for write: ") + path);
    return -1;
  }
  uint64_t header_len = header.size();
  bool ok = fwrite(&header_len, 8, 1, out) == 1 &&
            fwrite(header.data(), 1, header.size(), out) == header.size();
  for (int64_t i = 0; ok && i < n; ++i) {
    if (nbytes[i] > 0)
      ok = fwrite(datas[i], 1, static_cast<size_t>(nbytes[i]), out) == static_cast<size_t>(nbytes[i]);
  }
  ok = (fclose(out) == 0) && ok;
  if (!ok) {
    set_error(std::string("short write to ") + path);
    remove(path);
    return -1;
  }
  return 0;
}

}  // extern "C"
