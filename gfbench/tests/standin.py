"""A stand-in kind for the harness's tests: a window of counted work that
runs nothing of the program. Its window's record has the meanings every
kind keeps (``units`` replica-steps, one ``durations`` entry a unit), so
it reports whichever end-to-end metrics BENCHMARK.json lists its cell
under."""


class Session:
    def __init__(self, config, mix, seed, device):
        self.window = None
        self.traced = None

    def setup(self):
        pass

    def run_window(self, seconds):
        # 4 closed-loop units of 250 replica-steps each in 2 s
        self.window = {"seconds": 2.0, "items": 4, "failed": 0,
                       "durations": [0.5] * 4, "units": 1000}

    def run_traced(self, spans, window):
        with window:
            pass
        self.traced = {}

    def release(self):
        pass

    def readings(self, control=None):
        return {}
