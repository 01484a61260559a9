// Native SMPS .cor (MPS core) parser — the framework's data loader.
//
// Copy of csrc/smps_cor.cpp for sqlp_tpu_torch. Mirrors
// sqlp_tpu_torch/models/smps_cor.py exactly (itself the behavioral port
// of the reference's src/smps/smps_cor.jl): section set NAME/ROWS/COLUMNS/
// RHS/BOUNDS/ENDATA, '*' comments, header lines start at column 0, later
// duplicate entries overwrite, missing rhs = 0, default bounds [0, +inf),
// bound types LO/UP/FX/FR/MI/PL.
//
// Exposed through a C ABI consumed via ctypes
// (sqlp_tpu_torch/models/native.py).
// Two-phase protocol: parse -> query sizes -> fill caller-allocated numpy
// buffers -> free.

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <limits>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Triplet {
    int i, j;
    double v;
};

struct CorHandle {
    std::string problem_name;
    std::string directions;              // one char per row
    std::vector<std::string> row_names;
    std::vector<std::string> col_names;
    std::vector<Triplet> entries;        // in file order (overwrite on fill)
    std::vector<std::pair<int, double>> rhs;        // (row, value)
    std::vector<std::pair<int, double>> lo, up;     // (col, value)
    std::string error;
};

bool tokenize(const std::string& line, std::vector<std::string>* out) {
    out->clear();
    std::istringstream ss(line);
    std::string tok;
    while (ss >> tok) out->push_back(tok);
    return !out->empty();
}

int row_index(CorHandle* h, std::unordered_map<std::string, int>& map,
              const std::string& name) {
    auto it = map.find(name);
    return it == map.end() ? -1 : it->second;
}

// strict numeric parse; std::stod would throw through the C ABI (UB)
bool to_double(const std::string& s, double* out) {
    char* end = nullptr;
    *out = std::strtod(s.c_str(), &end);
    return end != s.c_str() && *end == '\0';
}

}  // namespace

extern "C" {

void* smps_cor_parse(const char* path, char* err, int errcap) {
    auto fail = [&](const std::string& msg) -> void* {
        if (err && errcap > 0) {
            std::snprintf(err, errcap, "%s", msg.c_str());
        }
        return nullptr;
    };

    std::ifstream in(path);
    if (!in) return fail(std::string("cannot open ") + path);

    auto h = new CorHandle();
    std::unordered_map<std::string, int> rowmap, colmap;
    std::string section;
    std::string line;
    std::vector<std::string> t;

    while (std::getline(in, line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        if (line.empty() || line[0] == '*') continue;
        if (!tokenize(line, &t)) continue;

        if (line[0] != ' ' && line[0] != '\t') {
            section = t[0];
            if (section != "NAME" && section != "ROWS" &&
                section != "COLUMNS" && section != "RHS" &&
                section != "BOUNDS" && section != "ENDATA") {
                delete h;
                return fail("Unsupported cor section '" + section + "'");
            }
            if (section == "NAME" && t.size() > 1) h->problem_name = t[1];
            continue;
        }

        if (section == "ROWS") {
            if (t.size() < 2) continue;
            h->directions.push_back(t[0][0]);
            rowmap.emplace(t[1], (int)h->row_names.size());
            h->row_names.push_back(t[1]);
        } else if (section == "COLUMNS") {
            auto it = colmap.find(t[0]);
            int j;
            if (it == colmap.end()) {
                j = (int)h->col_names.size();
                colmap.emplace(t[0], j);
                h->col_names.push_back(t[0]);
            } else {
                j = it->second;
            }
            for (size_t k = 1; k + 1 < t.size(); k += 2) {
                int i = row_index(h, rowmap, t[k]);
                if (i < 0) {
                    std::string msg = "unknown row '" + t[k] + "' in COLUMNS";
                    delete h;
                    return fail(msg);
                }
                double v;
                if (!to_double(t[k + 1], &v)) {
                    std::string msg = "bad number '" + t[k + 1] +
                                      "' in COLUMNS";
                    delete h;
                    return fail(msg);
                }
                h->entries.push_back({i, j, v});
            }
        } else if (section == "RHS") {
            for (size_t k = 1; k + 1 < t.size(); k += 2) {
                int i = row_index(h, rowmap, t[k]);
                if (i < 0) {
                    std::string msg = "unknown row '" + t[k] + "' in RHS";
                    delete h;
                    return fail(msg);
                }
                double v;
                if (!to_double(t[k + 1], &v)) {
                    std::string msg = "bad number '" + t[k + 1] + "' in RHS";
                    delete h;
                    return fail(msg);
                }
                h->rhs.push_back({i, v});
            }
        } else if (section == "BOUNDS") {
            if (t.size() < 3) continue;
            const std::string& btype = t[0];
            auto it = colmap.find(t[2]);
            if (it == colmap.end()) {
                std::string msg = "unknown column '" + t[2] + "' in BOUNDS";
                delete h;
                return fail(msg);
            }
            int j = it->second;
            const double inf = std::numeric_limits<double>::infinity();
            // LO/UP/FX carry a value token the 3-token guard above does
            // not cover; t[3] on a 3-token line would read out of bounds.
            double v = 0.0;
            if (btype == "LO" || btype == "UP" || btype == "FX") {
                if (t.size() < 4 || !to_double(t[3], &v)) {
                    std::string msg = "missing/bad bound value in: " + line;
                    delete h;
                    return fail(msg);
                }
            }
            if (btype == "LO") {
                h->lo.push_back({j, v});
            } else if (btype == "UP") {
                h->up.push_back({j, v});
            } else if (btype == "FX") {
                h->lo.push_back({j, v});
                h->up.push_back({j, v});
            } else if (btype == "FR") {
                h->lo.push_back({j, -inf});
                h->up.push_back({j, inf});
            } else if (btype == "MI") {
                h->lo.push_back({j, -inf});
            } else if (btype == "PL") {
                h->up.push_back({j, inf});
            } else {
                std::string msg = "Unsupported bound type " + btype +
                                  " for variable " + t[2];
                delete h;
                return fail(msg);
            }
        }
        // NAME data lines and ENDATA bodies are ignored (as in the port).
    }

    if (h->directions.empty() || h->directions[0] != 'N') {
        delete h;
        return fail("First row of cor file is not objective.");
    }
    return h;
}

int cor_n_rows(void* p) { return (int)((CorHandle*)p)->row_names.size(); }
int cor_n_cols(void* p) { return (int)((CorHandle*)p)->col_names.size(); }
long cor_nnz(void* p) { return (long)((CorHandle*)p)->entries.size(); }

// which: 0 = problem name, 1 = row names, 2 = col names ('\n'-joined)
long cor_names_size(void* p, int which) {
    auto h = (CorHandle*)p;
    if (which == 0) return (long)h->problem_name.size() + 1;
    const auto& v = which == 1 ? h->row_names : h->col_names;
    long total = 1;
    for (const auto& s : v) total += (long)s.size() + 1;
    return total;
}

void cor_names(void* p, int which, char* buf) {
    auto h = (CorHandle*)p;
    if (which == 0) {
        std::strcpy(buf, h->problem_name.c_str());
        return;
    }
    const auto& v = which == 1 ? h->row_names : h->col_names;
    char* out = buf;
    for (const auto& s : v) {
        std::memcpy(out, s.data(), s.size());
        out += s.size();
        *out++ = '\n';
    }
    *out = '\0';
}

void cor_directions(void* p, char* buf) {
    auto h = (CorHandle*)p;
    std::memcpy(buf, h->directions.data(), h->directions.size());
}

// Fill caller-allocated dense buffers: M [n_rows*n_cols] row-major, rhs
// [n_rows], lb/ub [n_cols]. Duplicates overwrite in file order.
void cor_fill_dense(void* p, double* M, double* rhs, double* lb, double* ub) {
    auto h = (CorHandle*)p;
    long nr = (long)h->row_names.size();
    long nc = (long)h->col_names.size();
    std::memset(M, 0, sizeof(double) * nr * nc);
    std::memset(rhs, 0, sizeof(double) * nr);
    const double inf = std::numeric_limits<double>::infinity();
    for (long j = 0; j < nc; ++j) {
        lb[j] = 0.0;
        ub[j] = inf;
    }
    for (const auto& e : h->entries) M[(long)e.i * nc + e.j] = e.v;
    for (const auto& r : h->rhs) rhs[r.first] = r.second;
    for (const auto& b : h->lo) lb[b.first] = b.second;
    for (const auto& b : h->up) ub[b.first] = b.second;
}

void cor_free(void* p) { delete (CorHandle*)p; }

}  // extern "C"
