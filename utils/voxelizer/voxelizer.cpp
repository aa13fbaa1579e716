// STL -> dense numpy bool voxel array for sailfish_tpu geometry setup.
//
// Counterpart of the reference's cvmlcpp-based voxelizer
// (reference utils/voxelizer/voxelizer.cpp:1-92, io.hpp): same CLI and
// on-disk formats (<base>.npy bool array + <base>.config JSON consumed by
// sailfish_tpu.converter.CoordinateConverter), but implemented from
// scratch with watertight parity-count ray casting (no vendored library).
//
// Usage: voxelizer <STL file> <output_base> [voxel_size]
//                  [--crop [pad]] [--subdomains [max_boxes [min_fill]]]
//   voxel_size is relative to the geometry scaled to unit length along its
//   longest axis (default 1/200 -> ~200 voxels; reference default equal).
//   --crop       shrink the output array to the fluid bounding box plus
//                `pad` solid layers (default 1) -- the behavior of the
//                reference's octree variant (voxelizer_octree.cpp:50-88),
//                implemented as a dense post-pass.
//   --subdomains recursively bisect the fluid bounding box into cuboids
//                until each reaches `min_fill` fluid fraction (default
//                0.5) or ~`max_boxes` (default 64, soft cap) exist; writes
//                <base>.subdomains as a JSON list of {pos, size,
//                fill_fraction} -- the reference's subdomain.cpp
//                ToSubdomains equivalent for decomposing sparse
//                geometries.
//
// Output array semantics: true (1) = solid/wall node, false (0) = fluid,
// shape (nz, ny, nx) with one padding layer of solid on every face.
//
// Build: make   (g++ -O2 -fopenmp)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

struct V3 {
    double x, y, z;
};

struct Tri {
    V3 a, b, c;
};

static bool read_stl(const std::string& path, std::vector<Tri>* tris) {
    std::ifstream in(path, std::ios::binary);
    if (!in) return false;
    char header[80];
    in.read(header, 80);
    if (!in) return false;

    // Heuristic: ASCII STL starts with "solid" and contains "facet".
    in.seekg(0);
    std::string start(6, '\0');
    in.read(&start[0], 6);
    bool is_ascii = start.rfind("solid", 0) == 0;
    if (is_ascii) {
        // confirm by looking for "facet" in the first 1KB
        char buf[1024] = {0};
        in.read(buf, sizeof(buf) - 1);
        is_ascii = strstr(buf, "facet") != nullptr;
    }
    in.clear();
    in.seekg(0);

    if (is_ascii) {
        std::string tok;
        std::vector<V3> verts;
        while (in >> tok) {
            if (tok == "vertex") {
                V3 v;
                in >> v.x >> v.y >> v.z;
                verts.push_back(v);
                if (verts.size() == 3) {
                    tris->push_back({verts[0], verts[1], verts[2]});
                    verts.clear();
                }
            }
        }
        return !tris->empty();
    }

    in.seekg(80);
    uint32_t n = 0;
    in.read(reinterpret_cast<char*>(&n), 4);
    tris->reserve(n);
    for (uint32_t i = 0; i < n; ++i) {
        float data[12];
        in.read(reinterpret_cast<char*>(data), sizeof(data));
        uint16_t attr;
        in.read(reinterpret_cast<char*>(&attr), 2);
        if (!in) return false;
        Tri t;
        t.a = {data[3], data[4], data[5]};
        t.b = {data[6], data[7], data[8]};
        t.c = {data[9], data[10], data[11]};
        tris->push_back(t);
    }
    return !tris->empty();
}

// Ray along +x from (ox, oy, oz): returns the x of the crossing with the
// triangle, or NaN. 2D point-in-triangle in the (y, z) plane.
static double ray_x_hit(const Tri& t, double oy, double oz) {
    const double y0 = t.a.y - oy, z0 = t.a.z - oz;
    const double y1 = t.b.y - oy, z1 = t.b.z - oz;
    const double y2 = t.c.y - oy, z2 = t.c.z - oz;
    // signed areas of the three sub-triangles with the origin
    const double d0 = y0 * z1 - y1 * z0;
    const double d1 = y1 * z2 - y2 * z1;
    const double d2 = y2 * z0 - y0 * z2;
    const bool has_neg = (d0 < 0) || (d1 < 0) || (d2 < 0);
    const bool has_pos = (d0 > 0) || (d1 > 0) || (d2 > 0);
    if (has_neg && has_pos) return NAN;
    const double denom = d0 + d1 + d2;
    if (denom == 0.0) return NAN;  // degenerate / edge-on
    // barycentric interpolation of x
    const double bx = (d1 * t.a.x + d2 * t.b.x + d0 * t.c.x) / denom;
    return bx;
}

static void write_npy(const std::string& fname,
                      const std::vector<uint8_t>& data,
                      size_t nz, size_t ny, size_t nx) {
    std::ofstream out(fname, std::ios::binary);
    out.write("\x93NUMPY\x01\x00", 8);
    char dict[192];
    snprintf(dict, sizeof(dict),
             "{'descr': '|b1', 'fortran_order': False, "
             "'shape': (%zu, %zu, %zu), }", nz, ny, nx);
    size_t len = strlen(dict);
    size_t total = ((len + 10) / 64 + 1) * 64;
    uint16_t dlen = static_cast<uint16_t>(total - 10);
    out.write(reinterpret_cast<char*>(&dlen), 2);
    out.write(dict, len);
    for (size_t i = len; i < total - 10 - 1; ++i) out.put(' ');
    out.put('\n');
    out.write(reinterpret_cast<const char*>(data.data()), data.size());
}

struct Box {
    long x0, y0, z0, x1, y1, z1;  // inclusive voxel bounds
    size_t fluid;

    long vol() const {
        return (x1 - x0 + 1) * (y1 - y0 + 1) * (z1 - z0 + 1);
    }
    double fill() const {
        return static_cast<double>(fluid) / vol();
    }
};

static size_t count_fluid(const std::vector<uint8_t>& vox, size_t nx,
                          size_t ny, const Box& b) {
    size_t n = 0;
    for (long z = b.z0; z <= b.z1; ++z)
        for (long y = b.y0; y <= b.y1; ++y)
            for (long x = b.x0; x <= b.x1; ++x)
                n += vox[(static_cast<size_t>(z) * ny + y) * nx + x] == 0;
    return n;
}

// Recursive bisection into cuboids with a target fluid fill fraction
// (analog of the reference's octree-leaf merging, subdomain.cpp).
static void split_subdomains(const std::vector<uint8_t>& vox, size_t nx,
                             size_t ny, Box b, double min_fill,
                             size_t max_boxes, std::vector<Box>* out) {
    if (b.fluid == 0) return;
    const long lx = b.x1 - b.x0 + 1, ly = b.y1 - b.y0 + 1,
               lz = b.z1 - b.z0 + 1;
    const long longest = std::max(lx, std::max(ly, lz));
    if (b.fill() >= min_fill || longest <= 4 ||
        out->size() + 2 > max_boxes) {
        out->push_back(b);
        return;
    }
    Box a = b, c = b;
    if (lz == longest) {
        a.z1 = b.z0 + lz / 2 - 1;
        c.z0 = a.z1 + 1;
    } else if (ly == longest) {
        a.y1 = b.y0 + ly / 2 - 1;
        c.y0 = a.y1 + 1;
    } else {
        a.x1 = b.x0 + lx / 2 - 1;
        c.x0 = a.x1 + 1;
    }
    a.fluid = count_fluid(vox, nx, ny, a);
    c.fluid = b.fluid - a.fluid;
    split_subdomains(vox, nx, ny, a, min_fill, max_boxes, out);
    split_subdomains(vox, nx, ny, c, min_fill, max_boxes, out);
}

int main(int argc, char** argv) {
    if (argc < 3) {
        std::cerr << "Usage: voxelizer <STL file> <output_base> "
                     "[voxel_size] [--crop [pad]] "
                     "[--subdomains [max_boxes [min_fill]]]\n";
        return -1;
    }
    const std::string stl_path = argv[1];
    const std::string out_base = argv[2];
    double voxel_size = 1.0 / 200.0;
    bool do_crop = false;
    int crop_pad = 1;
    bool do_subdomains = false;
    size_t max_boxes = 64;
    double min_fill = 0.5;
    int pos = 0;
    for (int i = 3; i < argc; ++i) {
        std::string arg = argv[i];
        if (arg == "--crop") {
            do_crop = true;
            if (i + 1 < argc && argv[i + 1][0] != '-')
                crop_pad = atoi(argv[++i]);
        } else if (arg == "--subdomains") {
            do_subdomains = true;
            if (i + 1 < argc && argv[i + 1][0] != '-')
                max_boxes = static_cast<size_t>(atoi(argv[++i]));
            if (i + 1 < argc && argv[i + 1][0] != '-')
                min_fill = atof(argv[++i]);
        } else if (pos == 0) {
            voxel_size = atof(argv[i]);
            pos++;
        }
    }

    std::vector<Tri> tris;
    if (!read_stl(stl_path, &tris)) {
        std::cerr << "Failed to read STL file " << stl_path << "\n";
        return -1;
    }

    // Bounding box.
    V3 lo = tris[0].a, hi = tris[0].a;
    for (const Tri& t : tris) {
        for (const V3* v : {&t.a, &t.b, &t.c}) {
            lo.x = std::min(lo.x, v->x); hi.x = std::max(hi.x, v->x);
            lo.y = std::min(lo.y, v->y); hi.y = std::max(hi.y, v->y);
            lo.z = std::min(lo.z, v->z); hi.z = std::max(hi.z, v->z);
        }
    }
    const double ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
    const double longest = std::max(ex, std::max(ey, ez));
    const double pitch = voxel_size * longest;  // physical voxel size
    const int pad = 1;

    const size_t nx = static_cast<size_t>(std::ceil(ex / pitch)) + 2 * pad;
    const size_t ny = static_cast<size_t>(std::ceil(ey / pitch)) + 2 * pad;
    const size_t nz = static_cast<size_t>(std::ceil(ez / pitch)) + 2 * pad;

    // true = solid; initialize everything solid, carve out the inside...
    // no: the STL interior is the SOLID obstacle in sailfish convention?
    // The reference marks inside=kFluid, outside=kWall: the STL describes
    // the fluid volume (e.g. a pipe's lumen). Same here: inside -> fluid.
    std::vector<uint8_t> vox(nx * ny * nz, 1);

    // Parity-count ray casting along +x per (y, z) row of voxel centers.
    // A small deterministic jitter avoids rays passing exactly through
    // vertices/edges.
    const double eps = 1e-9 * longest + 1e-12;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4)
#endif
    for (long long zi = 0; zi < static_cast<long long>(nz); ++zi) {
        std::vector<double> hits;
        for (size_t yi = 0; yi < ny; ++yi) {
            const double oy = lo.y + (static_cast<double>(yi) - pad + 0.5)
                * pitch + eps;
            const double oz = lo.z + (static_cast<double>(zi) - pad + 0.5)
                * pitch + eps;
            hits.clear();
            for (const Tri& t : tris) {
                const double h = ray_x_hit(t, oy, oz);
                if (!std::isnan(h)) hits.push_back(h);
            }
            if (hits.size() < 2) continue;
            std::sort(hits.begin(), hits.end());
            // dedupe near-identical crossings (shared edges)
            hits.erase(std::unique(hits.begin(), hits.end(),
                                   [&](double a, double b) {
                                       return std::fabs(a - b)
                                           < 1e-7 * longest;
                                   }),
                       hits.end());
            for (size_t k = 0; k + 1 < hits.size(); k += 2) {
                const double x0 = hits[k], x1 = hits[k + 1];
                long i0 = static_cast<long>(
                    std::ceil((x0 - lo.x) / pitch - 0.5)) + pad;
                long i1 = static_cast<long>(
                    std::floor((x1 - lo.x) / pitch - 0.5)) + pad;
                i0 = std::max(i0, 0L);
                i1 = std::min(i1, static_cast<long>(nx) - 1);
                for (long xi = i0; xi <= i1; ++xi) {
                    vox[(static_cast<size_t>(zi) * ny + yi) * nx + xi] = 0;
                }
            }
        }
    }

    size_t nx_out = nx, ny_out = ny, nz_out = nz;
    long off[3] = {0, 0, 0};
    if (do_crop) {
        // fluid bounding box (reference octree FindFluidExtent analog)
        long bx0 = static_cast<long>(nx), by0 = static_cast<long>(ny),
             bz0 = static_cast<long>(nz), bx1 = -1, by1 = -1, bz1 = -1;
        for (size_t z = 0; z < nz; ++z)
            for (size_t y = 0; y < ny; ++y)
                for (size_t x = 0; x < nx; ++x)
                    if (vox[(z * ny + y) * nx + x] == 0) {
                        bx0 = std::min(bx0, static_cast<long>(x));
                        bx1 = std::max(bx1, static_cast<long>(x));
                        by0 = std::min(by0, static_cast<long>(y));
                        by1 = std::max(by1, static_cast<long>(y));
                        bz0 = std::min(bz0, static_cast<long>(z));
                        bz1 = std::max(bz1, static_cast<long>(z));
                    }
        if (bx1 >= 0) {
            bx0 = std::max(0L, bx0 - crop_pad);
            by0 = std::max(0L, by0 - crop_pad);
            bz0 = std::max(0L, bz0 - crop_pad);
            bx1 = std::min(static_cast<long>(nx) - 1, bx1 + crop_pad);
            by1 = std::min(static_cast<long>(ny) - 1, by1 + crop_pad);
            bz1 = std::min(static_cast<long>(nz) - 1, bz1 + crop_pad);
            nx_out = bx1 - bx0 + 1;
            ny_out = by1 - by0 + 1;
            nz_out = bz1 - bz0 + 1;
            off[0] = bx0; off[1] = by0; off[2] = bz0;
            std::vector<uint8_t> cropped(nx_out * ny_out * nz_out);
            for (size_t z = 0; z < nz_out; ++z)
                for (size_t y = 0; y < ny_out; ++y)
                    memcpy(&cropped[(z * ny_out + y) * nx_out],
                           &vox[((z + bz0) * ny + y + by0) * nx + bx0],
                           nx_out);
            vox.swap(cropped);
            std::cout << "Cropped to fluid bbox + " << crop_pad
                      << ": offset " << bx0 << " " << by0 << " " << bz0
                      << "\n";
        }
    }

    size_t fluid = std::count(vox.begin(), vox.end(), 0);
    std::cout << "Nodes total: " << vox.size() << " active: "
              << std::round(fluid / static_cast<double>(vox.size())
                            * 10000) / 100.0 << "%\n";
    std::cout << "Lattice size: " << nx_out << " " << ny_out << " "
              << nz_out << "\n";

    write_npy(out_base + ".npy", vox, nz_out, ny_out, nx_out);

    if (do_subdomains) {
        Box root{0, 0, 0, static_cast<long>(nx_out) - 1,
                 static_cast<long>(ny_out) - 1,
                 static_cast<long>(nz_out) - 1, fluid};
        std::vector<Box> boxes;
        split_subdomains(vox, nx_out, ny_out, root, min_fill, max_boxes,
                         &boxes);
        std::ofstream sd(out_base + ".subdomains");
        sd << "[";
        for (size_t i = 0; i < boxes.size(); ++i) {
            const Box& b = boxes[i];
            sd << (i ? ",\n " : "\n ")
               << "{\"pos\": [" << b.x0 << ", " << b.y0 << ", " << b.z0
               << "], \"size\": [" << (b.x1 - b.x0 + 1) << ", "
               << (b.y1 - b.y0 + 1) << ", " << (b.z1 - b.z0 + 1)
               << "], \"fill_fraction\": " << b.fill() << "}";
        }
        sd << "\n]\n";
        std::cout << "Subdomains: " << boxes.size() << " boxes\n";
    }

    std::ofstream config(out_base + ".config");
    config << "{\"bounding_box\": ["
           << "[" << lo.x << ", " << hi.x << "], "
           << "[" << lo.y << ", " << hi.y << "], "
           << "[" << lo.z << ", " << hi.z << "]],"
           << "\"padding\": [1, 1, 1, 1, 1, 1],"
           << "\"axes\": \"xyz\","
           << "\"crop_offset\": [" << off[0] << ", " << off[1] << ", "
           << off[2] << "],"
           << "\"size\": [" << nz_out << ", " << ny_out << ", "
           << nx_out << "]}";
    return 0;
}
