"""NetCDF-3 codec round-trip + interop with scipy's independent implementation."""

import numpy as np
import pytest

from cfd_proxy.mesh import netcdf3


def _sample_ds():
    ds = netcdf3.Dataset()
    ds.attrs = {"title": "cfd-proxy test", "npart": 4, "scale": 2.5}
    ds.add("coords", ("points", "dim3"), np.arange(30, dtype=np.float64).reshape(10, 3))
    ds.add("faces", ("faces", "two"), np.arange(14, dtype=np.int32).reshape(7, 2))
    ds.add("normals", ("faces", "dim3"), np.random.default_rng(0).standard_normal((7, 3)))
    ds.add("volume", ("points",), np.linspace(1, 2, 10))
    ds.add("flag", ("points",), np.arange(10, dtype=np.int8))
    return ds


def test_roundtrip(tmp_path):
    p = str(tmp_path / "mesh.nc")
    ds = _sample_ds()
    netcdf3.write(p, ds)
    rd = netcdf3.read(p)
    assert rd.dims == ds.dims
    assert rd.attrs["title"] == "cfd-proxy test"
    assert rd.attrs["npart"] == 4
    assert rd.attrs["scale"] == 2.5
    for name, (dims, arr) in ds.variables.items():
        rdims, rarr = rd.variables[name]
        assert rdims == dims
        np.testing.assert_array_equal(rarr, arr)


def test_scipy_can_read_our_files(tmp_path):
    from scipy.io import netcdf_file

    p = str(tmp_path / "mesh.nc")
    netcdf3.write(p, _sample_ds())
    with netcdf_file(p, "r", mmap=False) as f:
        np.testing.assert_array_equal(
            f.variables["faces"][:], np.arange(14, dtype=np.int32).reshape(7, 2)
        )
        assert f.npart == 4


def test_we_can_read_scipy_files(tmp_path):
    from scipy.io import netcdf_file

    p = str(tmp_path / "sp.nc")
    with netcdf_file(p, "w") as f:
        f.createDimension("n", 5)
        v = f.createVariable("x", "d", ("n",))
        v[:] = np.arange(5.0)
        f.history = "scipy"
    rd = netcdf3.read(p)
    np.testing.assert_array_equal(rd["x"], np.arange(5.0))
    assert rd.attrs["history"] == "scipy"


def test_int64_rejected(tmp_path):
    ds = netcdf3.Dataset()
    ds.add("bad", ("n",), np.arange(4, dtype=np.int64))
    with pytest.raises(ValueError):
        netcdf3.write(str(tmp_path / "bad.nc"), ds)


def test_cdf2_roundtrip_and_scipy_interop(tmp_path):
    from scipy.io import netcdf_file

    p = str(tmp_path / "v2.nc")
    ds = _sample_ds()
    netcdf3.write(p, ds, version=2)
    with open(p, "rb") as f:
        assert f.read(4) == b"CDF\x02"  # 64-bit-offset magic
    rd = netcdf3.read(p)
    for name, (dims, arr) in ds.variables.items():
        np.testing.assert_array_equal(rd.variables[name][1], arr)
    with netcdf_file(p, "r", mmap=False, version=2) as f:
        np.testing.assert_array_equal(
            f.variables["faces"][:], np.arange(14, dtype=np.int32).reshape(7, 2)
        )


def test_truncated_file_rejected(tmp_path):
    p = str(tmp_path / "t.nc")
    netcdf3.write(p, _sample_ds())
    raw = open(p, "rb").read()
    bad = str(tmp_path / "bad.nc")
    open(bad, "wb").write(raw[: len(raw) // 3])
    with pytest.raises(Exception):
        netcdf3.read(bad)


def test_garbage_header_rejected(tmp_path):
    bad = str(tmp_path / "g.nc")
    open(bad, "wb").write(b"CDF\x01" + b"\xff" * 64)
    with pytest.raises(Exception):
        netcdf3.read(bad)


def test_partition_file_with_wrong_schema_version(tmp_path):
    from cfd_proxy.mesh.reader import read_partition

    p = str(tmp_path / "w.nc")
    ds = _sample_ds()
    ds.attrs["schema_version"] = 999
    netcdf3.write(p, ds)
    with pytest.raises(Exception):
        read_partition(p)


def test_partition_written_by_scipy_reads_back(tmp_path):
    """Schema interop: a partition file produced by a FOREIGN netCDF writer
    (scipy) must read through our reader — the on-disk format is the spec."""
    from scipy.io import netcdf_file

    from cfd_proxy.mesh.generator import generate_mesh
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.mesh.reader import read_partition, write_partition

    mesh = generate_mesh(5, 4, 4, seed=9)
    (part,) = partition_mesh(mesh, 1)
    ours = str(tmp_path / "ours.nc")
    write_partition(ours, part)

    # rewrite the same content through scipy
    theirs = str(tmp_path / "scipy.nc")
    src = netcdf3.read(ours)
    with netcdf_file(theirs, "w") as f:
        for k, v in src.attrs.items():
            setattr(f, k, v)
        for name, size in src.dims.items():
            f.createDimension(name, size)
        for name, (dims, arr) in src.variables.items():
            v = f.createVariable(name, arr.dtype.str.replace("=", "<"), dims)
            v[:] = arr

    p2 = read_partition(theirs)
    np.testing.assert_array_equal(p2.faces, part.faces)
    np.testing.assert_array_equal(p2.global_ids, part.global_ids)
    np.testing.assert_allclose(p2.normals, part.normals)
    assert p2.nowned == part.nowned


def test_writer_rejects_silent_data_loss(tmp_path):
    """Codec guards: multi-char strings (NC_CHAR keeps one byte), uint32
    (NC_INT is signed), and zero-length dims (read back as the record dim
    by standard tools) must all fail loudly instead of corrupting."""
    import pytest

    from cfd_proxy.utils.errors import CheckError

    ds = netcdf3.Dataset()
    ds.add("names", ("n",), np.array(["abc", "defg"]))
    with pytest.raises(ValueError, match="single-byte"):
        netcdf3.write(str(tmp_path / "a.nc"), ds)

    ds = netcdf3.Dataset()
    ds.add("x", ("d",), np.array([3_000_000_000], np.uint32))
    with pytest.raises(ValueError, match="uint32"):
        netcdf3.write(str(tmp_path / "b.nc"), ds)

    ds = netcdf3.Dataset()
    ds.add("y", ("empty",), np.zeros(0, np.int32))
    with pytest.raises(CheckError, match="zero-length"):
        netcdf3.write(str(tmp_path / "c.nc"), ds)


def test_reader_lazy_then_cached(tmp_path):
    """The read path stores mmap-backed big-endian views; __getitem__
    converts to a native-order (writeable) copy on first access and caches."""
    ds = netcdf3.Dataset()
    ds.add("v", ("n",), np.arange(5, dtype=np.int32))
    path = str(tmp_path / "lazy.nc")
    netcdf3.write(path, ds)
    rd = netcdf3.read(path)
    stored = rd.variables["v"][1]
    assert stored.dtype.byteorder == ">"       # untouched: still the view
    got = rd["v"]
    assert got.dtype.byteorder in ("=", "|", "<")
    assert got.flags.writeable
    assert rd["v"] is got                      # cached after first access
    np.testing.assert_array_equal(got, np.arange(5))


def test_reader_rejects_mismatched_comm_counts(tmp_path):
    """A file whose sendcount sum disagrees with the sendidx length must be
    rejected at read time (numpy slicing would clamp silently)."""
    import pytest

    from cfd_proxy.mesh.generator import generate_mesh
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.mesh.reader import read_partition, write_partition
    from cfd_proxy.utils.errors import CheckError

    mesh = generate_mesh(5, 4, 4, seed=9)
    parts = partition_mesh(mesh, 2)
    path = str(tmp_path / "p.nc")
    write_partition(path, parts[0])
    ds = netcdf3.read(path)
    bad = netcdf3.Dataset()
    bad.attrs = dict(ds.attrs)
    for name, (dims, _arr) in ds.variables.items():
        arr = ds[name]
        if name == "sendcount":
            arr = arr + 1       # counts no longer cover sendidx
        bad.add(name, dims, arr)
    netcdf3.write(path, bad)
    with pytest.raises(CheckError, match="sendcount"):
        read_partition(path)
