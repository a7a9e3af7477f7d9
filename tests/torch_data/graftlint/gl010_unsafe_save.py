"""GL010 fixture: state pickled straight into its destination file."""
import pickle


def save_world(world, path):
    with open(path, "wb") as fh:
        pickle.dump(world, fh)  # GL010: non-atomic state persistence
    return path


# the sanctioned form is clean: serialize to bytes, let guard.io land
# them atomically (temp file + fsync + os.replace)
def save_world_atomically(world, path, atomic_write_bytes):
    atomic_write_bytes(path, pickle.dumps(world))
    return path
